"""The port's emotion-wheel stack against the JAX package's: utils/xlsx.py
on the vendored assets and on hand-built workbooks, every `WheelMetrics`
mapping over assets/emotion_wheel as an equal dict (format.csv read by the
port's csv reader, JAX's by pandas), and the wheel, overlap and hit-rate
metrics identical on hypothesis-drawn label sets. All exact: both sides
run the same host arithmetic."""

import os
import zipfile

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from affectgpt_tpu import paths as jpaths
from affectgpt_tpu.evaluation import wheel as jwheel
from affectgpt_tpu.utils import xlsx as jxlsx
from affectgpt_tpu_torch import paths as tpaths
from affectgpt_tpu_torch.evaluation import wheel as twheel
from affectgpt_tpu_torch.utils import xlsx as txlsx
from tests.test_evaluation_wheel import write_xlsx

ROOT = tpaths.EMOTION_WHEEL_ROOT
WHEEL = {"jax": jwheel.WheelMetrics(ROOT), "port": twheel.WheelMetrics(ROOT)}
ASSETS = sorted(f for f in os.listdir(ROOT) if f.endswith(".xlsx"))
METRICS = [f"case3_{w}_{lvl}" for w in twheel.WHEELS for lvl in ("level1", "level2")] + [
    "case1", "case2"]


def test_default_roots_are_the_vendored_assets():
    assert tpaths.EMOTION_WHEEL_ROOT == jpaths.EMOTION_WHEEL_ROOT
    assert os.path.isfile(os.path.join(ROOT, "format.csv")) and len(ASSETS) == 6
    assert twheel.WheelMetrics().root == ROOT


@pytest.mark.parametrize("name", ASSETS)
def test_xlsx_rows_equal_jax_on_the_assets(name):
    path = os.path.join(ROOT, name)
    assert txlsx.read_rows(path) == jxlsx.read_rows(path)
    assert txlsx.read_dicts(path) == jxlsx.read_dicts(path)


def write_shared_string_workbook(path):
    """Two sheets: shared strings (one of rich-text runs), numbers, inline
    strings, empty cells, a column past Z and a row with no cells."""
    ns = 'xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main"'
    shared = (f'<sst {ns}><si><t>name</t></si><si><t>joy</t></si>'
              '<si><r><t>glad</t></r><r><t>ness</t></r></si><si><t/></si></sst>')
    sheet1 = (f'<worksheet {ns}><sheetData>'
              '<row r="1"><c r="A1" t="s"><v>0</v></c><c r="C1" t="inlineStr"><is><t>x</t>'
              '</is></c><c r="AB1" t="s"><v>2</v></c></row>'
              '<row r="2"><c r="A2" t="s"><v>1</v></c><c r="B2"><v>3.5</v></c>'
              '<c r="C2" t="s"><v>3</v></c></row><row r="3"/>'
              '<row r="4"><c r="B4" t="n"><v>-2</v></c><c r="D4" t="inlineStr"/></row>'
              '</sheetData></worksheet>')
    sheet2 = (f'<worksheet {ns}><sheetData><row r="1"><c r="B1" t="s"><v>2</v></c></row>'
              '</sheetData></worksheet>')
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr("xl/sharedStrings.xml", shared)
        zf.writestr("xl/worksheets/sheet1.xml", sheet1)
        zf.writestr("xl/worksheets/sheet2.xml", sheet2)


def test_xlsx_rows_equal_jax_on_hand_built_workbooks(tmp_path):
    shared = tmp_path / "shared.xlsx"
    write_shared_string_workbook(shared)
    inline = tmp_path / "inline.xlsx"
    write_xlsx(inline, ["level1", "level2", "level3"],
               [["joy", "happy", "cheerful"], [None, None, "content"], ["a", None, "1"]])
    for path in (shared, inline):
        for sheet in ((0, 1) if path == shared else (0,)):
            want = jxlsx.read_rows(str(path), sheet)
            assert txlsx.read_rows(str(path), sheet) == want
            assert txlsx.read_dicts(str(path), sheet) == jxlsx.read_dicts(str(path), sheet)
    rows = txlsx.read_rows(str(shared))
    assert rows[0][0] == "name" and rows[0][27] == "gladness" and rows[1][1] == "3.5"
    assert rows[2] == [None] * 28 and rows[3][1] == "-2"


@pytest.mark.parametrize("wheel", twheel.WHEELS)
def test_wheel_maps_and_clusters_equal_jax(wheel):
    assert WHEEL["port"].wheel_map(wheel) == WHEEL["jax"].wheel_map(wheel)
    for level in ("level1", "level2"):
        assert WHEEL["port"].wheel_cluster(wheel, level) == \
            WHEEL["jax"].wheel_cluster(wheel, level)


@pytest.mark.parametrize("mapping", ["candidate_labels", "synonym_mapping", "format_mapping"])
def test_label_space_mappings_equal_jax(mapping):
    got, want = getattr(WHEEL["port"], mapping)(), getattr(WHEEL["jax"], mapping)()
    assert got == want
    assert len(got) == {"candidate_labels": 253, "synonym_mapping": 1255,
                        "format_mapping": 7386}[mapping]


def test_format_csv_empty_cell_maps_only_its_name(tmp_path):
    """An empty `format` cell (NaN to pandas and to the port's reader) gives
    the name alone, on both sides: the vendored "no words" row, and a
    hand-written table with NA markers."""
    assert WHEEL["port"].format_mapping()["no words"] == ["no words"]
    (tmp_path / "format.csv").write_text(
        'name,format\nhappy,"happy,happily"\ncalm,\nsad,NA\n"x, y","[x]"\n')
    got = twheel.WheelMetrics(str(tmp_path)).format_mapping()
    assert got == jwheel.WheelMetrics(str(tmp_path)).format_mapping()
    assert got["calm"] == ["calm"] and got["sad"] == ["sad"]


VOCAB = sorted(WHEEL["port"].format_mapping())[::37] + ["xyzzy", "Happy", " sad ", "neutral"]
label_sets = st.lists(st.sampled_from(VOCAB), max_size=4).map(
    lambda words: "[" + ", ".join(words) + "]" if len(words) % 2 else ", ".join(words))
name_maps = st.dictionaries(st.sampled_from([f"n{i}" for i in range(8)]), label_sets,
                            min_size=1, max_size=6)


@settings(max_examples=40, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(gt=name_maps, pred_seed=st.integers(0, 2**16))
def test_wheel_and_hit_rate_metrics_identical(gt, pred_seed):
    rng = np.random.RandomState(pred_seed)
    pred = {n: ", ".join(rng.choice(VOCAB, rng.randint(0, 4))) for n in gt}
    names = sorted(gt)[: max(1, len(gt) // 2)]
    j, t = WHEEL["jax"], WHEEL["port"]
    for level in ("level1", "level2"):
        assert t.wheel_metric(gt, pred, level=level) == j.wheel_metric(gt, pred, level=level)
        assert t.wheel_metric(gt, pred, names, level) == j.wheel_metric(gt, pred, names, level)
        assert t.hitrate_metric(gt, pred, level) == j.hitrate_metric(gt, pred, level)
    for metric in METRICS:
        assert t.overlap_rate(gt, pred, metric) == j.overlap_rate(gt, pred, metric)
        assert t.onehot_hitrate(gt, pred, metric) == j.onehot_hitrate(gt, pred, metric)
    for n in gt:
        assert t.hit_or_not(gt[n], pred[n]) == j.hit_or_not(gt[n], pred[n])
        assert t.map_labels(VOCAB[:12], "case2") == j.map_labels(VOCAB[:12], "case2")
