"""The port's bookend alignment (``pqa2_tpu_torch.align``, the aligner and the
reference analyzer) against the JAX package's, on the CPU.

  (a) ``stats_and_thumbs``/``frame_luma_stats``/``thumb_series`` on uint8
      luma and on the f32 luma of a 10-bit clip divided by 4, 70 frames (a
      64-frame chunk and a short one);
  (b) ``BookendDetector.detect``/``detect_bookends`` and
      ``align_bookend_clips`` on tests/test_align.py's fixtures: the
      matching loop, the xcorr jitter, the fallback, the no-content error;
  (c) ``estimate_shifts``, ``compensate`` and ``motion_compensate_clip`` on
      tests/test_motioncomp.py's cases;
  (d) the streamed path at 8 and 10 bits against JAX's and against the
      port's in-memory path, and ``write_trim``'s bytes against JAX's;
  (e) ``BookendAligner.align_bookend_videos`` with and without motion
      compensation and ``ReferenceAnalyzer.get_video_info``: result dicts
      equal to JAX's (paths aside), aligned y4m files byte-identical;
  plus one ``cuda`` test: the card's statistics and phase correlation
  against the CPU's (run there with ``python -m pytest
  tests/test_torch_align.py -m cuda --noconftest``; that machine has no JAX,
  so JAX is imported inside the tests that need it).

The JAX side runs in this process, as the JAX package's own alignment tests
run it. Tolerances (each with its reason):
  histograms, white ratios, bookend sections, alignment dicts
  (``as_dict``), shifts, bytes:
                   equal (counts, and decisions taken on them; the means and
                   thumbnails equal JAX's in every bit at these sizes, as
                   pqa2_tpu_torch/align/stats.py says, so the confidence
                   does too)
  mean, thumbnails rtol 1e-5: JAX sums in f32, the port in float64
  std              rtol 1e-5, atol 1e-4 near 0: the same, through a square
                   root; a bookend's brightness and std_dev (means of the
                   per-frame values) the same
  card vs CPU      histograms, means and thumbnails equal (exact float64
                   sums of 8-bit codes); std rtol 1e-5

Keep this file below eight tests: pytest-xdist's ``--dist loadfile`` queues
files by their number of tests (ROADMAP Q1.0).
"""

import os

import numpy as np
import pytest
import torch

from pqa2_tpu_torch.io.y4m import write_y4m

RTOL = 1e-5
STD_ATOL = 1e-4
H, W = 64, 96


def _luma(seed, n=70, depth=8):
    """n frames of 8-bit codes (or 10-bit codes / 4 as f32): smooth random
    content, uniform white and black frames, and frames at the codes' ends."""
    rng = np.random.default_rng(seed)
    peak = (1 << depth) - 1
    base = rng.uniform(0, peak, size=(n, H, W))
    for _ in range(2):
        base = (base + np.roll(base, 1, -1) + np.roll(base, -1, -1)
                + np.roll(base, 1, -2) + np.roll(base, -1, -2)) / 5.0
    codes = np.round(base)
    codes[3] = 235 << (depth - 8)
    codes[4] = 0
    codes[5] = peak
    codes[6] = rng.integers(0, peak + 1, (H, W))
    if depth == 8:
        return codes.astype(np.uint8)
    return (codes / float(1 << (depth - 8))).astype(np.float32)


def test_stats_match_jax():
    from pqa2_tpu.align import stats as jax_stats
    from pqa2_tpu.align import temporal as jax_temporal
    from pqa2_tpu_torch.align.stats import frame_luma_stats, stats_and_thumbs, white_ratio
    from pqa2_tpu_torch.align.temporal import thumb_series

    for depth in (8, 10):
        luma = _luma(depth, depth=depth)
        got, got_thumbs = stats_and_thumbs(luma, device="cpu")
        want, want_thumbs = jax_stats.stats_and_thumbs(luma)
        sep = frame_luma_stats(luma, device="cpu")
        want_sep = jax_stats.frame_luma_stats(luma)
        for g, w in ((got, want), (sep, want_sep)):
            assert g["pixels"] == w["pixels"] == H * W
            np.testing.assert_array_equal(g["hist"], w["hist"])
            assert g["hist"].dtype == w["hist"].dtype
            np.testing.assert_array_equal(g["_above"], w["_above"])
            np.testing.assert_allclose(g["mean"], w["mean"], rtol=RTOL, atol=0)
            np.testing.assert_allclose(g["std"], w["std"], rtol=RTOL, atol=STD_ATOL)
            for t in (-1.0, 0.0, 100.5, 200.0, 234.0, 254.9, 255.0):
                np.testing.assert_array_equal(white_ratio(g, t), jax_stats.white_ratio(w, t))
        assert sep["hist"].sum(axis=1).tolist() == [H * W] * len(luma)
        np.testing.assert_allclose(got_thumbs, want_thumbs, rtol=RTOL, atol=0)
        # Below 2^16 pixels JAX's f32 sums are exact too: the same bits.
        np.testing.assert_array_equal(got["mean"], want["mean"])
        np.testing.assert_array_equal(got_thumbs, want_thumbs)
        np.testing.assert_array_equal(thumb_series(luma, device="cpu"), got_thumbs)
        np.testing.assert_allclose(jax_temporal.thumb_series(luma), got_thumbs, rtol=RTOL)
        assert got["std"][3] == 0.0 and got["mean"][3] == 235.0
        # A tensor input gives the same values, chunk boundary anywhere.
        again, _ = stats_and_thumbs(torch.from_numpy(luma), chunk_size=9, device="cpu")
        np.testing.assert_array_equal(again["hist"], got["hist"])
        np.testing.assert_array_equal(again["mean"], got["mean"])


def _bookend_cases():
    """(name, reference, capture, config kwargs, refine) on the fixtures of
    tests/test_align.py."""
    from test_align import _bookend_capture, _content_frame, _white_frame

    rng = np.random.default_rng(20261017)
    cap, loops = _bookend_capture(rng, n_loops=3, content_len=12)
    cases = [("matching loop", cap[loops[0][0]: loops[0][1]], cap,
              dict(min_white_frames=3, frame_offset=0), r) for r in (False, True)]
    content = [_content_frame(rng, level=90 + 6 * i) for i in range(16)]
    jitter = np.stack([_content_frame(rng, level=60)] * 2 + [_white_frame()] * 5
                      + [content[0]] * 2 + content + [_white_frame()] * 5)
    cases += [("xcorr jitter", np.stack(content), jitter,
               dict(min_white_frames=3, frame_offset=0), r) for r in (False, True)]
    plain = np.stack([_content_frame(rng, level=80) for _ in range(20)])
    cases += [("fallback", plain[:8], plain, {}, True),
              ("no fallback", plain[:8], plain, dict(fallback_to_full_video=False), True)]
    whites = np.stack([_white_frame() for _ in range(20)])
    cases += [("no content", np.stack([_content_frame(rng) for _ in range(5)]), whites,
               dict(fallback_to_full_video=False, min_white_frames=3), True)]
    return cases


def _outcome(fn):
    """fn()'s result, or the type and message of what it raised."""
    try:
        return fn()
    except ValueError as e:
        return ("raised", type(e).__name__, str(e))


def _same_bookends(got, want, name):
    """The same sections and flags; brightness and std_dev, means of the
    per-frame statistics, within the statistics' tolerance."""
    assert len(got) == len(want), name
    for g, w in zip(got, want):
        assert (g.start_frame, g.end_frame, g.is_fallback) == \
            (w.start_frame, w.end_frame, w.is_fallback), name
        np.testing.assert_allclose(g.brightness, w.brightness, rtol=RTOL, err_msg=name)
        np.testing.assert_allclose(g.std_dev, w.std_dev, rtol=RTOL, atol=STD_ATOL,
                                   err_msg=name)


def test_detection_and_alignment_match_jax():
    from pqa2_tpu import align as jax_align
    from pqa2_tpu_torch import align

    seen = set()
    for name, ref, cap, cfg, refine in _bookend_cases():
        want_b = jax_align.detect_bookends(cap, fps=30.0, config=jax_align.BookendConfig(**cfg))
        got_b = align.detect_bookends(cap, fps=30.0, config=align.BookendConfig(**cfg),
                                      device="cpu")
        _same_bookends(got_b, want_b, name)
        got_d = align.BookendDetector(align.BookendConfig(**cfg), device="cpu").detect(cap)
        assert got_d == got_b, name
        want = _outcome(lambda: jax_align.align_bookend_clips(
            ref, cap, fps=30.0, config=jax_align.BookendConfig(**cfg), refine=refine))
        got = _outcome(lambda: align.align_bookend_clips(
            ref, cap, fps=30.0, config=align.BookendConfig(**cfg), refine=refine, device="cpu"))
        if isinstance(want, tuple):
            assert got == want, name
            seen.add("raised")
            continue
        assert got.as_dict() == want.as_dict(), name
        _same_bookends(got.bookends, want.bookends, name)
        seen.add("fallback" if got.is_fallback else "bookend")
        if name == "xcorr jitter" and refine:
            assert got.cap_range[0] == 9  # the true start, 2 frames after the bookend math
    assert seen == {"bookend", "fallback", "raised"}


def _textured(rng, n=3, h=64, w=96):
    from test_motioncomp import _textured as textured

    return textured(rng, n, h, w)


def test_motion_compensation_matches_jax():
    from pqa2_tpu.align import motioncomp as jax_mc
    from pqa2_tpu_torch.align import motioncomp as mc

    rng = np.random.default_rng(7)
    ref = _textured(rng)
    true_shifts = np.array([[3, -5], [0, 7], [-4, 2]])
    mov = np.stack([np.roll(ref[i], tuple(true_shifts[i]), axis=(0, 1)) for i in range(3)])
    cases = {
        "round trip": (ref, mov, 32),
        "zero shift": (ref[:2], ref[:2].copy(), 32),
        "large shift": (ref[:1], np.roll(ref[:1], (0, 45), axis=(1, 2)), 32),
        "uint8 frames": (ref.astype(np.uint8), mov.astype(np.uint8), 4),
    }
    for name, (r, m, max_shift) in cases.items():
        est = mc.estimate_shifts(r, m, max_shift=max_shift, device="cpu")
        np.testing.assert_array_equal(est, jax_mc.estimate_shifts(r, m, max_shift=max_shift),
                                      err_msg=name)
        assert est.dtype == np.int32 and est.shape == (len(r), 2)
        comp, shifts = mc.motion_compensate_clip(r, m, max_shift=max_shift, device="cpu")
        want_comp, want_shifts = jax_mc.motion_compensate_clip(r, m, max_shift=max_shift)
        np.testing.assert_array_equal(shifts, want_shifts, err_msg=name)
        np.testing.assert_array_equal(comp, want_comp, err_msg=name)
        np.testing.assert_array_equal(mc.compensate(m, true_shifts[: len(m)]),
                                      jax_mc.compensate(m, true_shifts[: len(m)]))
    np.testing.assert_array_equal(mc.estimate_shifts(ref, mov, device="cpu"), -true_shifts)
    np.testing.assert_array_equal(mc.estimate_shifts(*cases["large shift"][:2], device="cpu"),
                                  [[0, 0]])
    # In chunks of CHUNK frames: the same shifts as one pass.
    many = np.concatenate([mov] * 12)
    np.testing.assert_array_equal(
        mc.estimate_shifts(np.concatenate([ref] * 12), many, device="cpu"),
        np.concatenate([-true_shifts] * 12))
    for mod in (mc, jax_mc):
        with pytest.raises(ValueError, match="equal shapes"):
            mod.motion_compensate_clip(ref, ref[:1], **({"device": "cpu"} if mod is mc else {}))


def _planes(ys, depth=8):
    h, w = ys[0].shape
    dt = np.uint8 if depth == 8 else np.uint16
    mid = 128 << (depth - 8)
    return [{"y": y.astype(dt), "u": np.full((h // 2, w // 2), mid, dt),
             "v": np.full((h // 2, w // 2), mid + 3, dt)} for y in ys]


def _write(path, ys, depth=8):
    write_y4m(path, _planes(ys, depth), colorspace="C420mpeg2" if depth == 8 else f"C420p{depth}")


def _capture(rng, depth, n=6):
    """(reference codes, capture codes): white bookends around two noisy
    loops of the reference (tests/test_streamed_align.py's cap_pair)."""
    s = 1 << (depth - 8)
    ref = rng.integers(16 * s, 220 * s, (n, H, W))
    white = np.full((H, W), 235 * s)
    noisy = np.clip(ref + rng.integers(-2 * s, 2 * s + 1, ref.shape), 0, 255 * s)
    return ref, np.stack([white] * 5 + list(noisy) + [white] * 5 + list(noisy) + [white] * 5)


def test_streamed_path_matches_jax_and_in_memory(tmp_path):
    from pqa2_tpu.align import streamed as jax_streamed
    from pqa2_tpu_torch.align import streamed
    from pqa2_tpu_torch.align.stats import stats_and_thumbs
    from pqa2_tpu_torch.align.temporal import align_bookend_clips

    rng = np.random.default_rng(9)
    for depth in (8, 10):
        ref, cap = _capture(rng, depth)
        rp, cp = str(tmp_path / f"r{depth}.y4m"), str(tmp_path / f"c{depth}.y4m")
        _write(rp, list(ref), depth)
        _write(cp, list(cap), depth)
        got, got_thumbs, info = streamed.streamed_stats_thumbs(cp, chunk=8, device="cpu")
        want, want_thumbs, want_info = jax_streamed.streamed_stats_thumbs(cp, chunk=8)
        assert info.as_dict() == want_info.as_dict() and info.bit_depth == depth
        np.testing.assert_array_equal(got["_above"], want["_above"])
        np.testing.assert_allclose(got["mean"], want["mean"], rtol=RTOL)
        np.testing.assert_allclose(got["std"], want["std"], rtol=RTOL, atol=STD_ATOL)
        np.testing.assert_allclose(got_thumbs, want_thumbs, rtol=RTOL)
        # The in-memory pass over the same luma on the 8-bit scale: the same values.
        scaled = (cap / float(1 << (depth - 8))).astype(np.float32)
        mem, mem_thumbs = stats_and_thumbs(scaled, device="cpu")
        for k in ("mean", "std", "_above"):
            np.testing.assert_array_equal(got[k], mem[k])
        np.testing.assert_array_equal(got_thumbs, mem_thumbs)
        result, ref_info, cap_info = streamed.streamed_align(rp, cp, device="cpu")
        want_result = jax_streamed.streamed_align(rp, cp)[0]
        assert result.as_dict() == want_result.as_dict()
        in_memory = align_bookend_clips((ref / float(1 << (depth - 8))).astype(np.float32),
                                        scaled, device="cpu")
        assert result.as_dict() == in_memory.as_dict()
        assert result.confidence > 0.5 and ref_info.frame_count == len(ref)
        for start, stop in ((2, 9), (0, 100), (30, 40)):
            a, b = str(tmp_path / "port.y4m"), str(tmp_path / "jax.y4m")
            for p in (a, b):
                if os.path.exists(p):
                    os.remove(p)
            n = streamed.write_trim(cp, a, start, stop)
            assert n == jax_streamed.write_trim(cp, b, start, stop)
            assert n == max(0, min(stop, len(cap)) - start)
            if n:
                assert open(a, "rb").read() == open(b, "rb").read()
            else:
                assert not os.path.exists(a) and not os.path.exists(b)


def _without_paths(d):
    return {k: v for k, v in d.items() if k not in ("aligned_reference", "aligned_captured")}


def test_engine_classes_match_jax(tmp_path):
    from pqa2_tpu.app.bookend_aligner import BookendAligner as JaxAligner
    from pqa2_tpu.app.options_manager import OptionsManager as JaxOptions
    from pqa2_tpu.app.reference_analyzer import ReferenceAnalyzer as JaxReference
    from pqa2_tpu_torch.app import BookendAligner, OptionsManager, ReferenceAnalyzer

    rng = np.random.default_rng(11)
    n = 6
    base = rng.uniform(16, 235, size=(n, H, W))
    for _ in range(2):
        base = (base + np.roll(base, 1, -1) + np.roll(base, -1, -1)
                + np.roll(base, 1, -2) + np.roll(base, -1, -2)) / 5.0
    ref = np.round(base).astype(np.uint8)
    white = np.full((H, W), 235, np.uint8)
    rp = str(tmp_path / "ref.y4m")
    write_y4m(rp, _planes(list(ref)))
    # The reference with white lead-in frames, for the bookend check.
    rwp = str(tmp_path / "ref_white.y4m")
    write_y4m(rwp, _planes([white] * 2 + list(ref)))
    # A capture whose content is rolled by (2, 6) in luma, (1, 3) in chroma.
    shifted = [{"y": np.roll(f["y"], (2, 6), axis=(0, 1)),
                "u": np.roll(f["u"], (1, 3), axis=(0, 1)),
                "v": np.roll(f["v"], (1, 3), axis=(0, 1))} for f in _planes(list(ref))]
    wf = _planes([white])[0]
    cap_frames = [wf] * 5 + shifted + [wf] * 5
    results = {}
    for side in ("jax", "port"):
        for mc in (False, True):
            d = tmp_path / f"{side}_{mc}"
            d.mkdir()
            cp = str(d / "cap.y4m")
            write_y4m(cp, cap_frames)
            om = (JaxOptions if side == "jax" else OptionsManager)(
                settings_file=str(d / "s.json"), save_debounce_s=0)
            om.update_setting("bookend", "frame_offset", 0)
            om.update_setting("bookend", "motion_compensation", mc)
            aligner = (JaxAligner(om) if side == "jax" else BookendAligner(om, device="cpu"))
            done = []
            aligner.alignment_complete.connect(done.append)
            res = aligner.align_bookend_videos(rp, cp)
            assert res is not None and done == [res]
            files = [open(res[k], "rb").read() for k in ("aligned_reference", "aligned_captured")]
            results[side, mc] = (_without_paths(res), files)
    for mc in (False, True):
        assert results["port", mc] == results["jax", mc]
        assert results["port", mc][0]["bookend_info"]["motion_compensated"] is mc
    # Compensation rewrote the capture window: the luma is the reference's
    # away from the refilled border strips.
    from pqa2_tpu_torch.io.y4m import read_y4m

    p = tmp_path / "port_True"
    got = np.stack([f["y"] for f in read_y4m(str(p / "cap_aligned.y4m"))[1]])
    want = np.stack([f["y"] for f in read_y4m(str(p / "cap_ref_aligned.y4m"))[1]])
    np.testing.assert_array_equal(got[:, 3:-3, 7:-7], want[:, 3:-3, 7:-7])

    for path in (rp, rwp, str(tmp_path / "missing.y4m")):
        infos = []
        for analyzer in (JaxReference(), ReferenceAnalyzer(device="cpu")):
            errors = []
            analyzer.error_occurred.connect(errors.append)
            infos.append((analyzer.get_video_info(path), bool(errors)))
        assert infos[0] == infos[1], path
    assert infos[0] == (None, True)
    assert ReferenceAnalyzer(device="cpu").get_video_info(rwp)["has_bookends"] is True
    assert ReferenceAnalyzer(device="cpu").get_video_info(rp)["has_bookends"] is False


@pytest.fixture()
def cuda_device():
    """The card for the test below; decided here, never at import."""
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs an sm_90 CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_card_stats_and_shifts_match_cpu(cuda_device):
    """The statistics and the phase correlation on the card against the
    CPU's, on 8-bit and 10-bit/4 luma at 1080p (a 64-frame chunk and a short
    one) and a capture rolled by (2, 6)."""
    from pqa2_tpu_torch.align.motioncomp import estimate_shifts
    from pqa2_tpu_torch.align.stats import stats_and_thumbs

    rng = np.random.default_rng(3)
    for depth in (8, 10):
        peak = (1 << depth) - 1
        codes = rng.integers(0, peak + 1, (70, 1080, 1920))
        codes[:3] = 235 << (depth - 8)
        luma = codes.astype(np.uint8) if depth == 8 else (codes / 4.0).astype(np.float32)
        card, card_thumbs = stats_and_thumbs(torch.from_numpy(luma).to(cuda_device),
                                             device=cuda_device)
        cpu, cpu_thumbs = stats_and_thumbs(luma, device="cpu")
        np.testing.assert_array_equal(card["hist"], cpu["hist"])
        np.testing.assert_array_equal(card["mean"], cpu["mean"])
        np.testing.assert_array_equal(card_thumbs, cpu_thumbs)
        np.testing.assert_allclose(card["std"], cpu["std"], rtol=RTOL, atol=0)
    ref = rng.integers(0, 256, (40, 1080, 1920)).astype(np.float32)
    ref = (ref + np.roll(ref, 1, -1) + np.roll(ref, 1, -2)) / 3.0
    mov = np.roll(ref, (2, 6), axis=(1, 2))
    card = estimate_shifts(torch.from_numpy(ref).to(cuda_device), mov, device=cuda_device)
    np.testing.assert_array_equal(card, estimate_shifts(ref, mov, device="cpu"))
    np.testing.assert_array_equal(card, np.tile([[-2, -6]], (40, 1)))
