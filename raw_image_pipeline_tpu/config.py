"""Configuration layer.

Frozen dataclasses mirroring the reference's YAML parameter schema 1:1, plus
loaders for the three reference file formats so existing files work verbatim:

  * pipeline params YAML      (reference: raw_image_pipeline/src/raw_image_pipeline/raw_image_pipeline.cpp:44-165,
                               config/pipeline_params_example.yaml)
  * Kalibr-style camera calib (reference: modules/undistortion.cpp:155-176,
                               config/alphasense_calib_example.yaml)
  * color calibration YAML    (reference: modules/color_calibration.cpp:52-76,
                               config/alphasense_color_calib_example.yaml)

Defaults below replicate the `utils::get(..., default)` fallbacks of the
reference loader exactly (raw_image_pipeline.cpp:58-163).

Known reference quirks handled here (see SURVEY.md §8):
  * `color_enhancer` enabled flag is read from key `run_color_enhancer`
    (raw_image_pipeline.cpp:137); we accept both `run_color_enhancer` and
    `enabled`.
  * The reference's color-enhancer YAML path leaves hue/saturation gains
    uninitialized C++ memory due to cross-wired setters
    (color_enhancer.cpp:23-33, raw_image_pipeline.cpp:143-145). That is
    undefined behavior with no well-defined output to match; we load the
    three gains straight through.
"""

from __future__ import annotations

import dataclasses
import math
import os
import re
from dataclasses import dataclass, field, replace
from typing import Any, List, Optional, Tuple

import numpy as np

_REPO_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_PARAMS_PATH = os.path.join(_REPO_DIR, "configs", "pipeline_params_example.yaml")
DEFAULT_CALIBRATION_PATH = os.path.join(_REPO_DIR, "configs", "alphasense_calib_example.yaml")
DEFAULT_COLOR_CALIBRATION_PATH = os.path.join(_REPO_DIR, "configs", "alphasense_color_calib_example.yaml")
DEFAULT_CCC_MODEL_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "models", "data", "ccc_default.bin"
)


def _get(node: Optional[dict], key: str, default):
    """YAML lookup with default, like utils::get (reference: utils.hpp:61-74)."""
    if not isinstance(node, dict):
        return default
    val = node.get(key, None)
    if val is None:
        return default
    return val


@dataclass(frozen=True)
class DebayerConfig:
    # reference defaults: raw_image_pipeline.cpp:58-64
    enabled: bool = True
    encoding: str = "auto"
    # Extension: which demosaic algorithm defines "the reference output".
    # "bilinear" matches the reference CPU path (cv::demosaicing + RGB/BGR
    # swap quirk, debayer.cpp:49-74); "mht" matches the reference GPU path
    # (Malvar-He-Cutler, debayer.cpp:89-120).
    algorithm: str = "bilinear"
    # Extension: 16-bit Bayer handling. "error" replicates the reference
    # (16-bit patterns are listed but unimplemented there and throw,
    # debayer.hpp:74-81); "scale8" demosaics at 16 bits then scales to the
    # 8-bit chain (>>8).
    bayer16: str = "error"


@dataclass(frozen=True)
class FlipConfig:
    # reference defaults: raw_image_pipeline.cpp:67-75
    enabled: bool = False
    angle: int = 0  # one of {0, 90, 180, 270}; others are a no-op (flip.cpp:37-58)


@dataclass(frozen=True)
class WhiteBalanceConfig:
    # reference defaults: raw_image_pipeline.cpp:78-95
    enabled: bool = False
    method: str = "ccc"  # simple | grey_world | gray_world | learned | ccc | pca
    clipping_percentile: float = 20.0
    saturation_bright_thr: float = 0.8
    saturation_dark_thr: float = 0.1
    temporal_consistency: bool = True
    # Extension: path to the FFCC model binary (reference hardcodes
    # model/default.bin, convolutional_color_constancy.cpp:16).
    ccc_model_path: str = DEFAULT_CCC_MODEL_PATH
    # CCC log-chroma origin (the reference node's setUV0 dynamic-reconfigure
    # knob, ccc.cpp:349-357 / cfg/RawImagePipelineWhiteBalance.cfg). A
    # runtime parameter in the built pipeline: retuning never recompiles.
    ccc_uv0: float = -1.421875


@dataclass(frozen=True)
class ColorCalibrationConfig:
    # reference defaults: raw_image_pipeline.cpp:98-103; identity matrix
    # (color_calibration.cpp:10-13), zero bias.
    enabled: bool = False
    # Row-major 3x3 BGR mixing matrix and length-3 BGR bias.
    matrix: Tuple[float, ...] = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0)
    bias: Tuple[float, ...] = (0.0, 0.0, 0.0)
    calibration_available: bool = False

    def matrix_np(self) -> np.ndarray:
        return np.asarray(self.matrix, dtype=np.float64).reshape(3, 3)

    def bias_np(self) -> np.ndarray:
        return np.asarray(self.bias, dtype=np.float64).reshape(3)


@dataclass(frozen=True)
class GammaCorrectionConfig:
    # reference defaults: raw_image_pipeline.cpp:106-115
    enabled: bool = False
    method: str = "custom"  # "custom" | "default" — both are the same LUT on CPU (gamma_correction.cpp:54-60)
    k: float = 0.8
    # Emulate the reference GPU backend for method="default":
    # cv::cuda::gammaCorrection applies NPP's FIXED BT.709 transfer curve,
    # ignoring k except for the direction flag is_forward = (k <= 1.0)
    # (gamma_correction.cpp:29-33, 66-74 — quirk §8.15). Set by the API when
    # use_gpu is selected.
    gpu: bool = False


@dataclass(frozen=True)
class VignettingCorrectionConfig:
    # reference defaults: raw_image_pipeline.cpp:118-128
    enabled: bool = False
    scale: float = 1.5
    a2: float = 1e-3
    a4: float = 1e-6


@dataclass(frozen=True)
class ColorEnhancerConfig:
    # reference defaults: raw_image_pipeline.cpp:131-146
    enabled: bool = False
    hue_gain: float = 1.0
    saturation_gain: float = 1.0
    value_gain: float = 1.0


@dataclass(frozen=True)
class UndistortionConfig:
    # reference defaults: raw_image_pipeline.cpp:149-160
    enabled: bool = False
    balance: float = 0.0
    fov_scale: float = 1.0
    # setNewImageSize (undistortion.cpp:28-31): scales the rectified camera
    # matrix; the maps (and hence the output) stay at the calibration size,
    # exactly as cv::fisheye::initUndistortRectifyMap is called with
    # dist_image_size_ in the reference (undistortion.cpp:216-238).
    # None = calibration size.
    new_image_size: Optional[Tuple[int, int]] = None  # (width, height)
    # cv::remap's u8 arithmetic is build-dependent; both forms are
    # replicated bit-for-bit (ops/undistortion.remap_precompute):
    #   "lerp"    — x86/IPP fma-lerp path (this repo's cv2 oracle; default)
    #   "fixed32" — non-IPP INTER_BITS=5 integer path (ARM/Jetson builds,
    #               the reference's deployment hardware; integer math,
    #               no emulated fmas)
    #   "float"   — quantization-free float formulation (within 1 LSB)
    interpolation: str = "lerp"


@dataclass(frozen=True)
class CameraCalibration:
    """Kalibr-style fisheye camera calibration.

    Mirrors UndistortionModule state (reference: undistortion.hpp:85-138,
    loadCalibration at undistortion.cpp:155-195). The reference always
    treats the distortion as the fisheye/equidistant model regardless of
    the `distortion_model` string (undistortion.cpp:199-220); only
    "none" disables undistortion (undistortion.hpp:76-78).
    """

    image_width: int = 320
    image_height: int = 240
    camera_name: str = ""
    # Row-major 3x3 intrinsics.
    camera_matrix: Tuple[float, ...] = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0)
    # 4 fisheye distortion coefficients.
    distortion_coefficients: Tuple[float, ...] = (0.0, 0.0, 0.0, 0.0)
    distortion_model: str = "none"
    rectification_matrix: Tuple[float, ...] = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0)
    # Row-major 3x4.
    projection_matrix: Tuple[float, ...] = (
        1.0, 0.0, 0.0, 0.0,
        0.0, 1.0, 0.0, 0.0,
        0.0, 0.0, 1.0, 0.0,
    )
    calibration_available: bool = False

    def K(self) -> np.ndarray:
        return np.asarray(self.camera_matrix, dtype=np.float64).reshape(3, 3)

    def D(self) -> np.ndarray:
        return np.asarray(self.distortion_coefficients, dtype=np.float64).reshape(4)

    def R(self) -> np.ndarray:
        return np.asarray(self.rectification_matrix, dtype=np.float64).reshape(3, 3)

    def P(self) -> np.ndarray:
        return np.asarray(self.projection_matrix, dtype=np.float64).reshape(3, 4)


@dataclass(frozen=True)
class PipelineConfig:
    """Full static configuration of the 8-stage chain (+ CCC).

    This is a *static* (trace-time) object: stage enables and methods select
    which ops get traced into the jitted ISP function, matching the fixed
    chain of raw_image_pipeline.hpp:143-172.
    """

    debayer: DebayerConfig = field(default_factory=DebayerConfig)
    flip: FlipConfig = field(default_factory=FlipConfig)
    white_balance: WhiteBalanceConfig = field(default_factory=WhiteBalanceConfig)
    color_calibration: ColorCalibrationConfig = field(default_factory=ColorCalibrationConfig)
    gamma_correction: GammaCorrectionConfig = field(default_factory=GammaCorrectionConfig)
    vignetting_correction: VignettingCorrectionConfig = field(default_factory=VignettingCorrectionConfig)
    color_enhancer: ColorEnhancerConfig = field(default_factory=ColorEnhancerConfig)
    undistortion: UndistortionConfig = field(default_factory=UndistortionConfig)
    calibration: CameraCalibration = field(default_factory=CameraCalibration)

    def replace(self, **kwargs) -> "PipelineConfig":
        return replace(self, **kwargs)


# ---------------------------------------------------------------------------
# Minimal YAML reader/writer
# ---------------------------------------------------------------------------
#
# The three reference schemas use a small YAML subset: block mappings,
# plain or quoted scalars, flow lists and comments. This reader covers
# exactly that subset with PyYAML's YAML 1.1 scalar typing (so e.g.
# `a2: 1e-3` is the STRING "1e-3", as under yaml.safe_load — the loaders
# below convert with float() either way), and the writer emits the same
# subset. Keeping it here means importing the package needs no PyYAML.

_YAML_NULL = ("", "~", "null", "Null", "NULL")
_YAML_TRUE = ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON")
_YAML_FALSE = ("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF")
_YAML_INT = re.compile(
    r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
    r"|[-+]?0x[0-9a-fA-F_]+)$"
)
_YAML_FLOAT = re.compile(
    r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$"
)


def _yaml_plain_scalar(text: str) -> Any:
    """YAML 1.1 typing of an unquoted scalar, as PyYAML's SafeLoader
    resolves it (sexagesimal numbers excepted)."""
    if text in _YAML_NULL:
        return None
    if text in _YAML_TRUE:
        return True
    if text in _YAML_FALSE:
        return False
    if _YAML_INT.match(text):
        v = text.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v.lstrip("+-")
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if len(v) > 1 and v[0] == "0":
            return sign * int(v, 8)
        return sign * int(v)
    if _YAML_FLOAT.match(text):
        v = text.replace("_", "").lower()
        if v.endswith(".inf"):
            return -math.inf if v[0] == "-" else math.inf
        if v.endswith(".nan"):
            return math.nan
        return float(v)
    return text


def _yaml_error(msg: str, lineno: int) -> ValueError:
    return ValueError(f"YAML line {lineno}: {msg}")


def _yaml_quoted(text: str, i: int, lineno: int) -> Tuple[str, int]:
    """Parse a quoted scalar starting at text[i]; return (value, end)."""
    q = text[i]
    out = []
    j = i + 1
    while j < len(text):
        c = text[j]
        if q == "'" and c == "'":
            if text[j + 1:j + 2] == "'":
                out.append("'")
                j += 2
                continue
            return "".join(out), j + 1
        if q == '"' and c == "\\":
            esc = text[j + 1:j + 2]
            out.append({"n": "\n", "t": "\t", '"': '"', "\\": "\\",
                        "/": "/", "0": "\0"}.get(esc, esc))
            j += 2
            continue
        if q == '"' and c == '"':
            return "".join(out), j + 1
        out.append(c)
        j += 1
    raise _yaml_error("unterminated quoted scalar", lineno)


def _yaml_flow(text: str, i: int, lineno: int) -> Tuple[Any, int]:
    """Parse a flow list or scalar inside a flow list at text[i]."""
    while i < len(text) and text[i] == " ":
        i += 1
    if text[i:i + 1] == "[":
        items: List[Any] = []
        i += 1
        while True:
            while i < len(text) and text[i] == " ":
                i += 1
            if text[i:i + 1] == "]":
                return items, i + 1
            item, i = _yaml_flow(text, i, lineno)
            items.append(item)
            while i < len(text) and text[i] == " ":
                i += 1
            if text[i:i + 1] == ",":
                i += 1
            elif text[i:i + 1] != "]":
                raise _yaml_error("malformed flow list", lineno)
    if text[i:i + 1] in ("'", '"'):
        return _yaml_quoted(text, i, lineno)
    j = i
    while j < len(text) and text[j] not in ",]":
        j += 1
    return _yaml_plain_scalar(text[i:j].strip()), j


def _yaml_value(text: str, lineno: int) -> Any:
    """A complete inline value: flow list, quoted or plain scalar."""
    if text[:1] in ("[", "'", '"'):
        value, end = _yaml_flow(text, 0, lineno)
        if text[end:].strip():
            raise _yaml_error(f"trailing text {text[end:]!r}", lineno)
        return value
    if text == "{}":
        return {}
    return _yaml_plain_scalar(text)


def _yaml_strip_comment(line: str) -> str:
    quote = None
    for i, c in enumerate(line):
        if quote:
            if c == quote:
                quote = None
        elif c in ("'", '"'):
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def load_yaml(text: str) -> Any:
    """Parse the YAML subset the reference schemas use (see above) into
    dicts, lists and scalars; None for an empty document, like
    yaml.safe_load."""
    lines = []
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = _yaml_strip_comment(raw)
        if not line.strip() or line.strip() in ("---", "..."):
            continue
        if "\t" in line[: len(line) - len(line.lstrip())]:
            raise _yaml_error("tab indentation", lineno)
        lines.append((len(line) - len(line.lstrip(" ")), line.strip(), lineno))
    if not lines:
        return None
    if len(lines) == 1 and not re.match(r"^[^'\"\[]*?:(?:\s|$)", lines[0][1]):
        return _yaml_value(lines[0][1], lines[0][2])

    pos = 0

    def block(indent: int) -> dict:
        nonlocal pos
        out: dict = {}
        while pos < len(lines):
            ind, body, lineno = lines[pos]
            if ind < indent:
                break
            if ind > indent:
                raise _yaml_error("unexpected indentation", lineno)
            if body[:1] in ("'", '"'):
                key, end = _yaml_quoted(body, 0, lineno)
                rest = body[end:].lstrip()
                if not rest.startswith(":"):
                    raise _yaml_error("expected ':' after key", lineno)
                rest = rest[1:].strip()
            else:
                m = re.match(r"^(.*?):(?:\s+(.*))?$", body)
                if m is None:
                    raise _yaml_error(f"expected 'key: value', got {body!r}", lineno)
                key = _yaml_plain_scalar(m.group(1).strip())
                rest = (m.group(2) or "").strip()
            pos += 1
            if rest:
                out[key] = _yaml_value(rest, lineno)
            elif pos < len(lines) and lines[pos][0] > indent:
                out[key] = block(lines[pos][0])
            else:
                out[key] = None
        return out

    result = block(lines[0][0])
    if pos < len(lines):
        raise _yaml_error("unexpected dedent", lines[pos][2])
    return result


def _yaml_scalar_text(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    if isinstance(v, (float, np.floating)):
        v = float(v)
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        r = repr(v)
        if "." not in r and "e" in r:  # YAML 1.1 floats need a dot
            m, e = r.split("e")
            r = f"{m}.0e{e}"
        return r
    s = str(v)
    plain_ok = (
        s and s == s.strip() and _yaml_plain_scalar(s) == s
        and s[0] not in "-?:,[]{}#&*!|>'\"%@`"
        and ": " not in s and " #" not in s and "\n" not in s
        and not s.endswith(":")
    )
    if plain_ok:
        return s
    if "\n" in s or "\\" in s:
        return '"' + s.replace("\\", "\\\\").replace('"', '\\"').replace(
            "\n", "\\n") + '"'
    return "'" + s.replace("'", "''") + "'"


def _yaml_inline(v: Any) -> str:
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_yaml_inline(x) for x in v) + "]"
    if isinstance(v, dict):
        if v:
            raise ValueError("nested mappings inside flow lists are not supported")
        return "{}"
    return _yaml_scalar_text(v)


def dump_yaml(obj: dict) -> str:
    """Write a mapping as block YAML with flow lists — the subset
    load_yaml reads (and yaml.safe_load reads identically)."""

    def emit(node: dict, indent: int, out: List[str]) -> None:
        for k, v in node.items():
            key = _yaml_scalar_text(k)
            if isinstance(v, dict) and v:
                out.append(" " * indent + f"{key}:")
                emit(v, indent + 2, out)
            else:
                out.append(" " * indent + f"{key}: {_yaml_inline(v)}")

    lines: List[str] = []
    emit(obj, 0, lines)
    return "\n".join(lines) + "\n"


def _read_yaml(path: str) -> dict:
    with open(path) as f:
        return load_yaml(f.read()) or {}


# ---------------------------------------------------------------------------
# YAML loaders
# ---------------------------------------------------------------------------

def load_pipeline_params(path: str, base: Optional[PipelineConfig] = None) -> PipelineConfig:
    """Load the reference pipeline-params YAML (raw_image_pipeline.cpp:44-165).

    Missing keys fall back to the reference's hardcoded defaults, not to
    `base`'s values, to match the reference loader (which rebuilds every
    module from scratch on loadParams). `base` only contributes the fields
    that are not covered by this YAML at all (calibrations, ccc model path,
    debayer algorithm).
    """
    base = base or PipelineConfig()
    if not os.path.exists(path):
        # reference: "Warning: parameters file doesn't exist" and keeps
        # whatever modules existed (raw_image_pipeline.cpp:163-164).
        return base

    node = _read_yaml(path)

    deb = node.get("debayer")
    flip = node.get("flip")
    wb = node.get("white_balance")
    cc = node.get("color_calibration")
    gam = node.get("gamma_correction")
    vig = node.get("vignetting_correction")
    ce = node.get("color_enhancer")
    und = node.get("undistortion")

    return PipelineConfig(
        debayer=DebayerConfig(
            enabled=bool(_get(deb, "enabled", True)),
            encoding=str(_get(deb, "encoding", "auto")),
            algorithm=base.debayer.algorithm,
        ),
        flip=FlipConfig(
            enabled=bool(_get(flip, "enabled", False)),
            angle=int(_get(flip, "angle", 0)),
        ),
        white_balance=WhiteBalanceConfig(
            enabled=bool(_get(wb, "enabled", False)),
            method=str(_get(wb, "method", "ccc")),
            clipping_percentile=float(_get(wb, "clipping_percentile", 20.0)),
            saturation_bright_thr=float(_get(wb, "saturation_bright_thr", 0.8)),
            saturation_dark_thr=float(_get(wb, "saturation_dark_thr", 0.1)),
            ccc_uv0=float(_get(wb, "ccc_uv0", -1.421875)),
            temporal_consistency=bool(_get(wb, "temporal_consistency", True)),
            ccc_model_path=base.white_balance.ccc_model_path,
        ),
        color_calibration=ColorCalibrationConfig(
            enabled=bool(_get(cc, "enabled", False)),
            matrix=base.color_calibration.matrix,
            bias=base.color_calibration.bias,
            calibration_available=base.color_calibration.calibration_available,
        ),
        gamma_correction=GammaCorrectionConfig(
            enabled=bool(_get(gam, "enabled", False)),
            method=str(_get(gam, "method", "custom")),
            k=float(_get(gam, "k", 0.8)),
            gpu=base.gamma_correction.gpu,
        ),
        vignetting_correction=VignettingCorrectionConfig(
            enabled=bool(_get(vig, "enabled", False)),
            scale=float(_get(vig, "scale", 1.5)),
            a2=float(_get(vig, "a2", 1e-3)),
            a4=float(_get(vig, "a4", 1e-6)),
        ),
        color_enhancer=ColorEnhancerConfig(
            # quirk: reference reads `run_color_enhancer` (raw_image_pipeline.cpp:137)
            enabled=bool(_get(ce, "run_color_enhancer", _get(ce, "enabled", False))),
            hue_gain=float(_get(ce, "hue_gain", 1.0)),
            saturation_gain=float(_get(ce, "saturation_gain", 1.0)),
            value_gain=float(_get(ce, "value_gain", 1.0)),
        ),
        undistortion=UndistortionConfig(
            enabled=bool(_get(und, "enabled", False)),
            balance=float(_get(und, "balance", 0.0)),
            fov_scale=float(_get(und, "fov_scale", 1.0)),
            # Extensions have no reference YAML key: carry them from
            # `base` so a params (re)load never silently resets a
            # programmatic setting (the interpolation choice in particular
            # survives the control channel's reload_params)
            new_image_size=base.undistortion.new_image_size,
            interpolation=str(
                _get(und, "interpolation", base.undistortion.interpolation)
            ),
        ),
        calibration=base.calibration,
    )


def load_camera_calibration(path: str) -> CameraCalibration:
    """Load a camera_calibration_parsers-style YAML (undistortion.cpp:155-176)."""
    if not os.path.exists(path):
        # reference fallback values: undistortion.cpp:178-195
        return CameraCalibration(calibration_available=False)

    node = _read_yaml(path)

    def mat_data(key, n, default):
        sub = node.get(key)
        data = _get(sub, "data", None)
        if data is None or len(data) != n:
            return tuple(default)
        return tuple(float(x) for x in data)

    return CameraCalibration(
        image_width=int(_get(node, "image_width", 320)),
        image_height=int(_get(node, "image_height", 240)),
        camera_name=str(_get(node, "camera_name", "")),
        camera_matrix=mat_data("camera_matrix", 9, (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0)),
        distortion_coefficients=mat_data("distortion_coefficients", 4, (0.0, 0.0, 0.0, 0.0)),
        distortion_model=str(_get(node, "distortion_model", "none")),
        rectification_matrix=mat_data(
            "rectification_matrix", 9, (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0)
        ),
        projection_matrix=mat_data(
            "projection_matrix",
            12,
            (1.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0),
        ),
        calibration_available=True,
    )


def load_color_calibration(path: str, base: Optional[ColorCalibrationConfig] = None) -> ColorCalibrationConfig:
    """Load the color-calibration matrix+bias YAML (color_calibration.cpp:52-76)."""
    base = base or ColorCalibrationConfig()
    if not os.path.exists(path):
        return replace(base, calibration_available=False)

    node = _read_yaml(path)

    mat = _get(node.get("matrix"), "data", None)
    bias = _get(node.get("bias"), "data", None)
    matrix = tuple(float(x) for x in mat) if mat is not None and len(mat) == 9 else (
        1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0
    )
    bias_t = tuple(float(x) for x in bias) if bias is not None and len(bias) == 3 else (0.0, 0.0, 0.0)
    return replace(base, matrix=matrix, bias=bias_t, calibration_available=True)


def save_color_calibration(path: str, config: ColorCalibrationConfig) -> None:
    """Write the color-calibration YAML in the reference schema
    (scripts/color_calibration.py:294-304)."""
    out = {
        "matrix": {"rows": 3, "cols": 3, "data": [float(x) for x in config.matrix]},
        "bias": {"rows": 3, "cols": 1, "data": [float(x) for x in config.bias]},
    }
    with open(path, "w") as f:
        f.write(dump_yaml(out))
