"""The package's own YAML reader/writer (config.load_yaml / dump_yaml):
PyYAML's safe_load typing on the shipped configs, the loaders' results,
and round trips — so importing the package needs no PyYAML."""

import glob
import math
import os
import subprocess
import sys

import pytest
import yaml

from raw_image_pipeline_tpu import config as cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml")))


def test_all_shipped_configs_listed():
    assert len(CONFIGS) == 5


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_reader_matches_pyyaml_and_loaders(path, monkeypatch):
    with open(path) as f:
        text = f.read()
    assert cfg.load_yaml(text) == yaml.safe_load(text)
    ours = (cfg.load_pipeline_params(path), cfg.load_camera_calibration(path),
            cfg.load_color_calibration(path))
    monkeypatch.setattr(cfg, "load_yaml", yaml.safe_load)
    theirs = (cfg.load_pipeline_params(path),
              cfg.load_camera_calibration(path),
              cfg.load_color_calibration(path))
    assert ours == theirs


@pytest.mark.parametrize("token", [
    "1e-3", "1.0e-3", "1.0e+3", "1.5", "-2", "+3", "0", "007", "0x1F",
    "0b101", "1_000", ".5", "-.inf", "true", "False", "yes", "off", "~",
    "null", "abc", "'q'", '"d\\tq"', "1.", "none", "equidistant", "3.",
    "[1, 2.5, [3, 'a'], []]", "1e5", "1.0e5",
])
def test_scalar_typing_matches_pyyaml(token):
    want = yaml.safe_load(f"k: {token}")["k"]
    got = cfg.load_yaml(f"k: {token}  # comment")["k"]
    assert got == want and type(got) is type(want)


def test_nan_and_empty_document():
    assert math.isnan(cfg.load_yaml("k: .nan")["k"])
    assert cfg.load_yaml("# only a comment\n") is None


def test_writer_round_trips():
    obj = {
        "a": {"b": [1.0, 2e-5, 1e20, -0.0, float("inf")], "c": "true",
              "d": "", "e": "x: y", "f": "it's", "g": None, "h": True,
              "i": {"j": [["n", 1], []]}},
        "k": "line\nbreak", "l": {}, "m": "-x", "n": "plain text", "o": 7,
    }
    text = cfg.dump_yaml(obj)
    assert cfg.load_yaml(text) == obj
    assert yaml.safe_load(text) == obj


def test_save_color_calibration_round_trips(tmp_path):
    cc = cfg.ColorCalibrationConfig(
        matrix=(2.4276948, 0.21479778, -0.30818, 0.09277014, 1.1962607,
                -0.09772757, -0.24436986, -0.22239459, 2.099912),
        bias=(0.5, -1.0, 2e-6),
    )
    path = str(tmp_path / "cc.yaml")
    cfg.save_color_calibration(path, cc)
    back = cfg.load_color_calibration(path)
    assert back.matrix == cc.matrix and back.bias == cc.bias
    with open(path) as f:
        assert yaml.safe_load(f)["matrix"]["data"] == list(cc.matrix)


def test_import_needs_neither_pyyaml_nor_cv2():
    code = """
import sys
class Block:
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("yaml", "cv2"):
            raise ImportError(name)
sys.meta_path.insert(0, Block())
import jax; jax.config.update("jax_platforms", "cpu")
import raw_image_pipeline_tpu
import raw_image_pipeline_tpu.parallel.multicamera
import raw_image_pipeline_tpu.runtime.stream
from raw_image_pipeline_tpu import RawImagePipeline
RawImagePipeline()
assert "yaml" not in sys.modules and "cv2" not in sys.modules
print("IMPORT_OK")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "IMPORT_OK" in out.stdout
