"""The port's config against the JAX package's: `Config.from_file`,
`from_dict`, dot overrides and `paths:` sections, on every YAML of
train_configs/, and `chip_smoke.py` phase 9's dict literal against
mercaptionplus_bestsetup.yaml. Also the port's override typing against
PyYAML's on its own (the port reads overrides without PyYAML)."""

import datetime
import math
from pathlib import Path

import pytest
import yaml

import chip_smoke
from affectgpt_tpu import config as jconfig
from affectgpt_tpu import paths as jpaths
from affectgpt_tpu_torch import config as tconfig
from affectgpt_tpu_torch import paths as tpaths

REPO = Path(__file__).resolve().parent.parent
TRAIN_CONFIGS = sorted((REPO / "train_configs").glob("*.yaml"))
OPTIONS = ["run.max_epoch=2", "run.init_lr=1e-5", "run.remat=dots", "run.evaluate=yes",
           "model.lora_dropout=0", "datasets.mercaptionplus.ratio=0.5", "run.tags=[a, 'b c', 3]",
           "run.resume_ckpt_path=null", "run.warmup_lr=1.0e-6", "inference.epoch=latest"]


def test_there_are_nine_train_configs():
    assert len(TRAIN_CONFIGS) == 9


@pytest.mark.parametrize("path", TRAIN_CONFIGS, ids=lambda p: p.stem[-40:])
@pytest.mark.parametrize("options", [None, OPTIONS], ids=["plain", "overrides"])
def test_from_file_equals_jax(path, options):
    want = jconfig.Config.from_file(str(path), options=options)
    got = tconfig.Config.from_file(str(path), options=options)
    assert got.to_dict() == want.to_dict()
    assert (got.name, got.cfg_path, got.output_dir) == (want.name, want.cfg_path, want.output_dir)
    assert got.run.get("seed") == want.run.get("seed")
    assert isinstance(got.model, tconfig.ConfigNode)
    assert got.datasets.get("nope", 3) == 3


VALUES = ["1", "-3", "012", "0x1F", "0b101", "1_000", "3.5", "1e-5", "1.0e-5", ".5", "-.inf",
          "true", "True", "yes", "no", "on", "OFF", "null", "~", "", "hello", "'quoted'",
          '"dq"', "[a, b]", "[1,2.5,true]", "[]", "[[1,2],[3]]", "{a: 1, b: [x]}",
          "some/path.yaml", "2024-01-01", "+1", "Qwen25", "'it''s'", "dots"]


@pytest.mark.parametrize("text", VALUES)
def test_override_values_typed_as_yaml(text):
    got, want = tconfig.parse_scalar(text), yaml.safe_load(text)
    assert type(got) is type(want) and got == want


def test_nan_override():
    assert math.isnan(tconfig.parse_scalar(".nan"))
    assert tconfig.parse_scalar("2024-01-01") == datetime.date(2024, 1, 1)


def test_dot_overrides_equal_jax_and_reject_bad_ones():
    assert tconfig.parse_dot_overrides(OPTIONS) == jconfig.parse_dot_overrides(OPTIONS)
    with pytest.raises(ValueError):
        tconfig.parse_dot_overrides(["noequalsign"])
    with pytest.raises(ValueError):
        tconfig.parse_dot_overrides(["a=1", "a.b=2"])


def test_paths_section_feeds_both_tables(tmp_path):
    section = {"DATA_DIR": {"MER2023": str(tmp_path / "m23")},
               "PATH_TO_LABEL": {"MER2023": str(tmp_path / "m23" / "l.npz")}}
    saved = {k: dict(tpaths.TABLES[k]) for k in section}
    try:
        got = tconfig.Config.from_dict({"paths": section, "run": {"seed": 1}})
        assert "paths" not in got.to_dict() and got.run.seed == 1
        assert tpaths.DATA_DIR["MER2023"] == section["DATA_DIR"]["MER2023"]
        assert tpaths.PATH_TO_LABEL["MER2023"] == section["PATH_TO_LABEL"]["MER2023"]
        with pytest.raises(KeyError):
            tpaths.update_from_dict({"NOPE": {}})
    finally:
        for k, v in saved.items():
            tpaths.TABLES[k].clear()
            tpaths.TABLES[k].update(v)


def test_path_tables_equal_jax():
    for name in ("PATH_TO_LLM", "PATH_TO_VISUAL", "PATH_TO_AUDIO", "DATA_DIR",
                 "PATH_TO_RAW_AUDIO", "PATH_TO_RAW_VIDEO", "PATH_TO_RAW_FACE",
                 "PATH_TO_TRANSCRIPTIONS", "PATH_TO_LABEL", "FEATURE_ROOT",
                 "EMOTION_WHEEL_ROOT", "RESULT_ROOT"):
        assert getattr(tpaths, name) == getattr(jpaths, name), name


def test_phase9_literal_is_the_bestsetup_file():
    """chip_smoke.py has no YAML parser on the card: its literal holds the
    model, datasets and run nodes of mercaptionplus_bestsetup.yaml, and run
    A's overrides are the listed ones alone."""
    path = REPO / "train_configs" / "mercaptionplus_bestsetup.yaml"
    want = tconfig.Config.from_file(str(path)).to_dict()
    assert {k: want[k] for k in ("model", "datasets", "run")} == chip_smoke.BESTSETUP
    options = [f"run.{k}={v}" for k, v in chip_smoke.RUN_A_OVERRIDES.items()]
    with_overrides = tconfig.Config.from_file(str(path), options=options).to_dict()
    literal = tconfig.Config.from_dict(chip_smoke.BESTSETUP,
                                       options=options).to_dict()
    assert {k: with_overrides[k] for k in ("model", "datasets", "run")} == \
        {k: literal[k] for k in ("model", "datasets", "run")}
    assert set(chip_smoke.RUN_A_OVERRIDES) == {
        "max_epoch", "iters_per_epoch", "warmup_steps", "log_freq", "evaluate", "val_iters"}
    run = chip_smoke.BESTSETUP["run"]
    model = chip_smoke.BESTSETUP["model"]
    assert (run["batch_size_train"], run["remat"], model["lora_r"], model["lora_dropout"],
            model["max_length"], model["video_fusion_type"]) == (4, False, 16, 0.05, 1024,
                                                                 "attention")
