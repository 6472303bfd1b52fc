"""The config loader's YAML subset parser against PyYAML on every shipped
config, and on OpenCV's %YAML:1.0 dialect."""

import pathlib

import pytest

from lvt_tpu.config import load_kitti_calib, parse_opencv_yaml

yaml = pytest.importorskip("yaml")

CONFIGS = pathlib.Path(__file__).resolve().parents[1] / "lvt_tpu" / "configs"
SHIPPED = sorted(CONFIGS.rglob("*.yaml"))


def test_all_shipped_configs_are_covered():
    assert len(SHIPPED) == 27


@pytest.mark.parametrize("path", SHIPPED,
                         ids=[str(p.relative_to(CONFIGS)) for p in SHIPPED])
def test_shipped_config_matches_pyyaml(path):
    text = path.read_text()
    assert parse_opencv_yaml(text) == (yaml.safe_load(text) or {})


def test_opencv_dialect(tmp_path):
    text = (
        "%YAML:1.0\n---\n"
        "camera_matrix: !!opencv-matrix\n"
        "   rows: 3\n   cols: 3\n   dt: d\n"
        "   data: [ 7.18856e+02, 0., 6.071928e+02, 0.,\n"
        "       7.18856e+02, 1.852157e+02, 0., 0., 1. ]\n"
        "baseline: 0.5371657  # metres\n"
        "viewer_camera_size:\n"
        "name: \"a # not a comment\"\n"
    )
    plain = text.replace("%YAML:1.0\n", "").replace("!!opencv-matrix", "")
    got = parse_opencv_yaml(text)
    assert got == yaml.safe_load(plain)
    assert got["camera_matrix"]["data"][2] == pytest.approx(607.1928)
    assert got["viewer_camera_size"] is None
    p = tmp_path / "calib.yml"
    p.write_text(text)
    assert load_kitti_calib(str(p)) == pytest.approx(
        {"fx": 718.856, "cx": 607.1928, "fy": 718.856, "cy": 185.2157,
         "baseline": 0.5371657})


def test_rejects_what_it_does_not_understand():
    with pytest.raises(ValueError):
        parse_opencv_yaml("- a\n- b\n")
    with pytest.raises(ValueError):
        parse_opencv_yaml("data: [1, 2,\n 3\n")
