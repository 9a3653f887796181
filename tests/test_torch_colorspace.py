"""The port's colorspace conversions (``pqa2_tpu_torch/ops/colorspace.py``)
against the JAX package's (``pqa2_tpu/ops/colorspace.py``), in process, on
the same seeded numpy inputs.

  * bit-equal: the UYVY unpack and pack, and the three chroma resamplers on
    integer inputs (the same bytes moved; the box averages sum a 2x2 or 2x1
    block and then divide, as ``jnp.mean`` does, exactly for integers);
  * ``rgb_to_yuv`` / ``yuv_to_rgb`` within atol 1e-4 on 8-bit levels: the
    port adds three f32 products per channel in column order where XLA's
    dot may reassociate or fuse them. Measured on the CPU (x86-64): at
    most 1.53e-5 on this file's inputs and 3.05e-5 on other seeds, one f32
    ulp of the output.

Keep this file below eight tests: pytest-xdist's ``--dist loadfile`` queues
files by their number of tests (ROADMAP Q1.0).
"""

import numpy as np
import pytest
import torch

from pqa2_tpu.ops import colorspace as jax_cs
from pqa2_tpu_torch import ops
from pqa2_tpu_torch.ops import colorspace as cs

RGB_ATOL = 1e-4
FUNCTIONS = ("rgb_to_yuv", "yuv_to_rgb", "uyvy422_to_planar", "planar_to_uyvy422",
             "chroma_420_to_444", "chroma_444_to_420", "chroma_422_to_420")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(a, b, where):
    a, b = _np(a), _np(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (where, a.dtype, b.dtype, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=where)


def test_exports_and_constants():
    for name in FUNCTIONS:
        assert getattr(ops, name) is getattr(cs, name)
    assert cs._KR_KB == jax_cs._KR_KB
    for st in cs._KR_KB:
        np.testing.assert_array_equal(cs._matrix(st), jax_cs._matrix(st))


def test_uyvy_pack_unpack_bit_equal():
    rng = np.random.default_rng(20)
    for shape in ((1, 4), (6, 16), (3, 10, 24), (2, 2, 8, 12)):
        packed = rng.integers(0, 256, shape).astype(np.uint8)
        got, want = cs.uyvy422_to_planar(packed), jax_cs.uyvy422_to_planar(packed)
        assert set(got) == set(want) == {"y", "u", "v"}
        for k in "yuv":
            _same(got[k], want[k], f"{shape} {k}")
        _same(cs.planar_to_uyvy422(got["y"], got["u"], got["v"]),
              jax_cs.planar_to_uyvy422(want["y"], want["u"], want["v"]), f"{shape} pack")
        _same(cs.planar_to_uyvy422(got["y"], got["u"], got["v"]), packed, f"{shape} round trip")
    layout = cs.uyvy422_to_planar(torch.tensor([[1, 2, 3, 4]], dtype=torch.uint8))
    assert [layout[k].tolist() for k in "yuv"] == [[[2, 4]], [[1]], [[3]]]


def test_chroma_resamplers_bit_equal():
    rng = np.random.default_rng(21)
    for shape in ((4, 6), (7, 9), (3, 10, 12), (2, 5, 8)):
        for dtype, hi in ((np.uint8, 256), (np.uint16, 1024), (np.float32, 256)):
            c = rng.integers(0, hi, shape).astype(dtype)
            for name in ("chroma_420_to_444", "chroma_444_to_420", "chroma_422_to_420"):
                _same(getattr(cs, name)(c), getattr(jax_cs, name)(c),
                      f"{name} {shape} {dtype.__name__}")
    t = torch.arange(24, dtype=torch.uint8).reshape(4, 6)
    assert cs.chroma_444_to_420(t).device == t.device and \
        cs.chroma_420_to_444(t).dtype == torch.uint8


@pytest.mark.parametrize("standard", ["bt601", "bt709"])
@pytest.mark.parametrize("full_range", [False, True])
def test_rgb_yuv_match_jax(standard, full_range):
    rng = np.random.default_rng(22)
    rgb = rng.integers(0, 256, (3, 20, 24, 3)).astype(np.uint8)
    rgb[0, 0, :4] = [[0, 0, 0], [255, 255, 255], [255, 0, 0], [0, 0, 255]]
    yuv = cs.rgb_to_yuv(rgb, standard, full_range)
    want = np.asarray(jax_cs.rgb_to_yuv(rgb, standard, full_range))
    assert yuv.dtype == torch.float32 and yuv.shape == want.shape
    np.testing.assert_allclose(yuv.numpy(), want, rtol=0, atol=RGB_ATOL)
    levels = np.clip(np.round(want), 0, 255).astype(np.float32)
    back = cs.yuv_to_rgb(torch.from_numpy(levels), standard, full_range)
    np.testing.assert_allclose(back.numpy(), np.asarray(jax_cs.yuv_to_rgb(
        levels, standard, full_range)), rtol=0, atol=RGB_ATOL)
    np.testing.assert_allclose(cs.yuv_to_rgb(yuv, standard, full_range).numpy(), rgb,
                               rtol=0, atol=1e-2)
    if not full_range and standard == "bt709":
        np.testing.assert_allclose(yuv[0, 0, :2].numpy(), [[16, 128, 128], [235, 128, 128]],
                                   atol=1e-3)
