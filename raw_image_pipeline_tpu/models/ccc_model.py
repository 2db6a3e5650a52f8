"""FFCC ("convolutional color constancy") model loading.

Binary layout (reference: convolutional_color_constancy.cpp:116-133):

    int32   width
    int32   height
    float32 filter[width*height]   (row-major, width rows after transpose)
    float32 bias[width*height]

The reference loads filter/bias as (height, width) row-major and immediately
transposes both (ccc.cpp:131-132), so the arrays used at runtime are
(width, height). For the shipped default model width == height == 256.

We additionally precompute the rfft2 of filter and bias once at load time —
the reference recomputes neither per frame (ccc.cpp:154-155), and neither do
we.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class CCCModel:
    """Loaded FFCC model. `filt` and `bias` are the post-transpose arrays
    (shape (width, height)) exactly as the reference holds them in memory.

    The response convolution is computed as DFT-by-matmul (ten real
    256x256 matmuls, ops/ccc.ccc_response), so the model precomputes the full complex
    2-D DFT of the filter as two real arrays. The bias enters the response
    purely additively — IDFT(DFT(bias)) is bias itself — so its spatial
    form is all that's needed.
    """

    width: int
    height: int
    filt: np.ndarray  # (W, H) float32
    bias: np.ndarray  # (W, H) float32
    # Full 2-D DFT of filt, split into real/imag float32 (W, H).
    filt_dft_re: np.ndarray
    filt_dft_im: np.ndarray

    @property
    def filt_fft(self) -> np.ndarray:
        """rfft2 of the filter (complex64) — host-side/test use only."""
        return np.fft.rfft2(self.filt.astype(np.float64)).astype(np.complex64)

    @property
    def bias_fft(self) -> np.ndarray:
        """rfft2 of the bias (complex64) — host-side/test use only."""
        return np.fft.rfft2(self.bias.astype(np.float64)).astype(np.complex64)


def load_ccc_model(path: str) -> CCCModel:
    with open(path, "rb") as f:
        header = f.read(8)
        width, height = struct.unpack("<ii", header)
        n = width * height
        filt = np.frombuffer(f.read(4 * n), dtype="<f4").reshape(height, width)
        bias = np.frombuffer(f.read(4 * n), dtype="<f4").reshape(height, width)

    # Transpose as the reference does (ccc.cpp:131-132).
    filt_t = np.ascontiguousarray(filt.T)
    bias_t = np.ascontiguousarray(bias.T)

    filt_dft = np.fft.fft2(filt_t.astype(np.float64))

    return CCCModel(
        width=width,
        height=height,
        filt=filt_t,
        bias=bias_t,
        filt_dft_re=filt_dft.real.astype(np.float32),
        filt_dft_im=filt_dft.imag.astype(np.float32),
    )


def save_ccc_model(path: str, filt: np.ndarray, bias: np.ndarray) -> None:
    """Write a model in the reference binary layout. `filt`/`bias` are given
    in the runtime (post-transpose) orientation (W, H)."""
    w, h = filt.shape
    with open(path, "wb") as f:
        f.write(struct.pack("<ii", w, h))
        f.write(np.ascontiguousarray(filt.T, dtype="<f4").tobytes())
        f.write(np.ascontiguousarray(bias.T, dtype="<f4").tobytes())
