"""The port's native frame pump (``pqa2_tpu_torch/io/native.py`` over
``csrc/framepump.cpp``) against its Python reader and writer, on the CPU.

  * ``NativeY4MReader`` gives the port's ``Y4MReader`` frames byte for byte
    at 8 and 10 bits, one at a time and through ``read_batch``; a truncated
    file and a missing one raise ``IOError``;
  * ``NativeY4MWriter`` writes the bytes ``Y4MWriter`` writes, 8 and 10
    bits;
  * ``stream_score`` reads y4m through the pump (``_open_reader``) and gives
    the Python reader's per-frame values in every bit, mixed depths too;
  * ``write_trim`` writes through the pump (``_open_native``) the bytes the
    Python writer writes.

The library is built with g++ into ``build/pqa2_tpu_torch/`` at first use,
apart from the JAX package's ``native/libframepump.so``. Keep this file
below eight tests: pytest-xdist's ``--dist loadfile`` queues files by their
number of tests (ROADMAP Q1.0).
"""

import os

import numpy as np
import pytest

from pqa2_tpu_torch.io import native
from pqa2_tpu_torch.io.y4m import Y4MHeader, Y4MReader, Y4MWriter, header_line, write_y4m
from test_torch_fast import _smooth


def _frames(rng, n, h, w, depth):
    dt = np.uint8 if depth == 8 else np.uint16
    hi = 1 << depth
    return [{"y": rng.integers(0, hi, (h, w)).astype(dt),
             "u": rng.integers(0, hi, (h // 2, w // 2)).astype(dt),
             "v": rng.integers(0, hi, (h // 2, w // 2)).astype(dt)} for _ in range(n)]


def _cs(depth):
    return "C420mpeg2" if depth == 8 else f"C420p{depth}"


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for p in "yuv":
            assert x[p].dtype == y[p].dtype and x[p].tobytes() == y[p].tobytes()


def test_reader_matches_python_reader(tmp_path):
    assert native.is_available()
    assert native._LIB_PATH.endswith(os.path.join("build", "pqa2_tpu_torch", "libframepump.so"))
    rng = np.random.default_rng(1)
    for depth in (8, 10):
        frames = _frames(rng, 7, 32, 48, depth)
        path = str(tmp_path / f"clip{depth}.y4m")
        write_y4m(path, frames, fps=(24, 1), colorspace=_cs(depth))
        with native.NativeY4MReader(path) as r:
            assert (r.width, r.height, r.bit_depth) == (48, 32, depth)
            assert r.fps == pytest.approx(24.0)
            got = list(r)
        py = Y4MReader(path)
        try:
            _same(got, list(py))
        finally:
            py.close()
        _same(got, frames)
        with native.NativeY4MReader(path) as r:
            batch, rest = r.read_batch(4), r.read_batch(10)
            assert r.read_frame() is None
        _same(batch + rest, frames)
        assert len(rest) == 3  # a short read at the end


def test_truncated_and_missing_files_raise(tmp_path):
    path = str(tmp_path / "clip.y4m")
    write_y4m(path, _frames(np.random.default_rng(2), 4, 32, 48, 8))
    trunc = str(tmp_path / "trunc.y4m")
    with open(path, "rb") as f:
        data = f.read()
    with open(trunc, "wb") as f:
        f.write(data[:-100])
    with native.NativeY4MReader(trunc) as r:
        with pytest.raises(IOError):
            while r.read_frame() is not None:
                pass
    with native.NativeY4MReader(trunc) as r:
        with pytest.raises(IOError):
            r.read_batch(8)
    with pytest.raises(IOError):
        native.NativeY4MReader(str(tmp_path / "missing.y4m"))


def test_writer_byte_identical(tmp_path):
    rng = np.random.default_rng(3)
    for depth in (8, 10):
        frames = _frames(rng, 5, 32, 48, depth)
        header = Y4MHeader(width=48, height=32, fps_num=30, fps_den=1, colorspace=_cs(depth))
        py_path, nat_path = str(tmp_path / f"py{depth}.y4m"), str(tmp_path / f"nat{depth}.y4m")
        w = Y4MWriter(py_path, header)
        for fr in frames:
            w.write_frame(fr)
        w.close()
        payload = sum(frames[0][p].nbytes for p in "yuv")
        with native.NativeY4MWriter(nat_path, header_line(header), payload) as nw:
            for fr in frames:
                nw.write_payload(np.concatenate([fr[p].view(np.uint8).ravel() for p in "yuv"]))
            with pytest.raises(ValueError, match="bytes"):
                nw.write_payload(np.zeros(payload - 1, np.uint8))
        with open(py_path, "rb") as a, open(nat_path, "rb") as b:
            assert a.read() == b.read()


def test_stream_score_through_the_pump(tmp_path, monkeypatch):
    from pqa2_tpu_torch.io.video import VideoReader
    from pqa2_tpu_torch.pipeline import streaming

    r, d = _smooth(4, 6, 48, 64, 8)
    r10 = _smooth(5, 6, 48, 64, 10)[0]
    c8, c10 = np.full((24, 32), 128, np.uint8), np.full((24, 32), 512, np.uint16)
    paths = {}
    for name, ys, c, cs in (("ref", r.astype(np.uint8), c8, "C420mpeg2"),
                            ("dist", d.astype(np.uint8), c8, "C420mpeg2"),
                            ("ref10", r10.astype(np.uint16), c10, "C420p10")):
        paths[name] = str(tmp_path / f"{name}.y4m")
        write_y4m(paths[name], [{"y": y, "u": c, "v": c} for y in ys], colorspace=cs)
    reader = streaming._open_reader(paths["ref"])
    try:
        assert isinstance(reader, native.NativeY4MReader)
        assert streaming._reader_depth(reader) == 8
    finally:
        reader.close()
    pairs = (("ref", "dist"), ("ref10", "dist"))
    got = [streaming.stream_score(paths[a], paths[b], chunk_size=4, device="cpu")
           for a, b in pairs]
    monkeypatch.setattr(streaming, "_open_reader", VideoReader)
    want = [streaming.stream_score(paths[a], paths[b], chunk_size=4, device="cpu")
            for a, b in pairs]
    for g, w in zip(got, want):
        assert g.peak == w.peak
        arrays = [(g.vmaf, w.vmaf)] + [(g.features[k], w.features[k]) for k in w.features]
        arrays += [(g.psnr[k], w.psnr[k]) for k in w.psnr]
        arrays += [(g.ssim[k], w.ssim[k]) for k in w.ssim]
        for a, b in arrays:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert got[1].peak == 1023.0


def test_write_trim_through_the_pump(tmp_path, monkeypatch):
    from pqa2_tpu_torch.align import streamed

    for depth in (8, 10):
        src = str(tmp_path / f"src{depth}.y4m")
        write_y4m(src, _frames(np.random.default_rng(depth), 9, 32, 48, depth),
                  colorspace=_cs(depth))
        calls = []
        open_native = streamed._open_native

        def spy(*a):
            w = open_native(*a)
            calls.append(type(w).__name__)
            return w

        monkeypatch.setattr(streamed, "_open_native", spy)
        nat = str(tmp_path / f"nat{depth}.y4m")
        assert streamed.write_trim(src, nat, 2, 7) == 5
        assert calls == ["NativeY4MWriter"]
        monkeypatch.setattr(streamed, "_open_native", lambda *a: None)
        py = str(tmp_path / f"py{depth}.y4m")
        assert streamed.write_trim(src, py, 2, 7) == 5
        monkeypatch.setattr(streamed, "_open_native", open_native)
        with open(nat, "rb") as a, open(py, "rb") as b:
            assert a.read() == b.read()
        with native.NativeY4MReader(nat) as r:
            assert r.bit_depth == depth and len(list(r)) == 5
