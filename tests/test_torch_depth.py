"""The port at 10, 12 and 16 bits and on the NEG and 4K models, against the
JAX package and the numpy oracles, on the CPU.

  * the integer VIF twin (``ops/vif_int.py``, the plain version of kernels
    1 and 1f) at 12 and 16 bits: every scale's LUT accumulators and
    decimated planes equal to the oracle's (``pqa2_tpu/golden/vif_int.py``)
    on smooth frames and frames at the largest codes, the exact features
    within 2e-6 of the oracle there and equal to JAX's
    ``vif_features_int_batched`` (the XLA twin tests/test_pallas_int.py
    holds its Pallas kernel to) on the 12-bit and 16-bit clips JAX scores
    below, the fast ones within 2e-6 of JAX's;
  * the integer ADM twin (``ops/adm_int.py``, kernel 3's plain version) at
    10, 12 and 16 bits, on smooth frames and on frames at the largest
    codes, where level 0's row pass passes 2^31 at 16 bits: pooled cube
    sums equal to the oracle's (gain limits 100 and 1.0) and JAX's (100),
    adm2 the oracle's f32 and within 2e-6 of JAX's;
  * ``stream_score``'s >8-bit branch against JAX's ``stream_score`` on
    6-frame 72x96 4:2:0 pairs at 10 bits, 12 bits and an 8-bit reference
    against a 10-bit distorted clip, the port's in chunks of 4 (both halos
    of one boundary and a short tail), with ``vmaf_v0.6.1`` and
    ``vmaf_float_v0.6.1``;
  * 16 bits, which y4m cannot carry, through ``score_clip`` against JAX's
    ``score_clip(bit_depth=16)``;
  * ``vmaf_v0.6.1neg`` and ``vmaf_4k_v0.6.1neg`` (kernels 1 and 3 at gain
    limit 1.0) and ``vmaf_4k_v0.6.1`` through ``stream_score`` against
    JAX's.

The JAX side runs in two child interpreters started together, each about
half of it (tests/test_torch_fast.py:jax_child's environment, so XLA emits
no FMA), while the port scores its runs. Each turns off the C++ dispatch fast
path of ``jax.jit``: in this JAX version a jitted integer feature program
run a second time in one process through that path is handed its two
arguments without the two constants it was compiled with ("Execution
supplied 2 buffers but compiled program expected 4", ROADMAP Records), so
with the fast path on, each compiled integer program could run once per
process. The Python dispatch path passes the constants and runs the same
executable.

Tolerances (each with its reason):
  integer stages      equal (LUT accumulators, decimated planes, pooled cube
                      sums)
  vif_scale*          integer: equal to JAX (the same integer sums and f32
                      combine), atol 2e-6 vs the float64 oracle;
                      integer_fast: atol 2e-6 vs JAX (tests/test_torch_fast.py);
                      float: atol 5e-5 (tests/test_torch_inmemory.py)
  adm2                integer atol 2e-6 (f32 cbrt ulp), float 5e-5
  motion/motion2      integer rtol 1e-6 (JAX's f32 hi/lo SAD fold), float
                      rtol 1e-5
  VMAF                atol 1e-3 integer, 5e-3 float (PERF.md section 2)
  SSIM                atol 1e-6; finite PSNR atol 1e-4 dB (JAX sums the SSE
                      in f32; the port's is exact)

Keep this file below eight tests: pytest-xdist's ``--dist loadfile`` queues
files by their number of tests (ROADMAP Q1.0).
"""

import numpy as np
import pytest
import torch

from test_torch_fast import jax_child
from test_torch_slice import _clip

from pqa2_tpu.golden.fixedpoint import VIF_FILTERS_Q16
from pqa2_tpu_torch.io.y4m import write_y4m

N = 6  # frames of each 72x96 clip
CHUNK = 4
FEATURES = ("adm2", "motion", "motion2", "vif_scale0", "vif_scale1", "vif_scale2",
            "vif_scale3")

VIF_ATOL = 2e-6
ADM_ATOL = 2e-6
MOTION_RTOL = 1e-6
VMAF_ATOL = {"integer": 1e-3, "float": 5e-3}
FLOAT_ATOL = 5e-5
FLOAT_MOTION_RTOL = 1e-5
SSIM_ATOL = 1e-6
PSNR_ATOL = 1e-4

# The streamed pairs: name -> (reference depth, distorted depth).
PAIRS = {"10": (10, 10), "12": (12, 12), "8_10": (8, 10)}
MODELS = {"vmaf_v0.6.1": "integer", "vmaf_float_v0.6.1": "float"}
VIF_DEPTHS = (12, 16)
ADM_DEPTHS = (10, 12, 16)

# Turns off jax.jit's C++ fast path (module docstring).
_NO_FASTPATH = """
import jax._src.pjit as _pjit
_pjit._get_fastpath_data = lambda *a, **k: None
"""

# The two children, each about the same work: a JAX integer feature program
# compiles for ~18 s on the CPU, a float one for ~6 s, one per bit depth,
# gain limit and chunk position, so JAX scores each clip as one chunk
# (chunk_size 8); the port's per-frame values do not depend on the chunks
# (tests/test_torch_inmemory.py), and it scores in chunks of 4.
_JAX_A = _NO_FASTPATH + """
from pqa2_tpu.ops.adm_int import adm_from_digit_sums_batched, adm_pooled_digit_sums_batched
from pqa2_tpu.ops.vif_int import vif_features_int_batched
from pqa2_tpu.pipeline.streaming import stream_score
out = {}
for pair, model in (("10", "vmaf_v0.6.1"), ("10", "vmaf_float_v0.6.1"),
                    ("8_10", "vmaf_v0.6.1"), ("8_10", "vmaf_float_v0.6.1"),
                    ("10", "vmaf_4k_v0.6.1")):
    out[pair, model] = stream_score(str(z["ref_" + pair]), str(z["dist_" + pair]),
                                    model=model, chunk_size=8)
for depth in (12, 16):
    out["vif_fast", depth] = np.asarray(vif_features_int_batched(
        jnp.asarray(z[f"vif{depth}_r8"]), jnp.asarray(z[f"vif{depth}_d8"]), bit_depth=depth,
        exact=False))
for depth in (10, 12, 16):
    r, d = jnp.asarray(z[f"adm{depth}_r8"]), jnp.asarray(z[f"adm{depth}_d8"])
    digits = adm_pooled_digit_sums_batched(r, d, 100.0, depth)
    out["adm", depth] = (np.asarray(digits), np.asarray(
        adm_from_digit_sums_batched(digits, r.shape[-2], r.shape[-1])))
with open(sys.argv[2], "wb") as fh:
    pickle.dump(out, fh)
"""

_JAX_B = _NO_FASTPATH + """
from pqa2_tpu.pipeline.scoring import score_clip
from pqa2_tpu.pipeline.streaming import stream_score
out = {}
for model in ("vmaf_v0.6.1", "vmaf_float_v0.6.1"):
    out["12", model] = stream_score(str(z["ref_12"]), str(z["dist_12"]), model=model,
                                    chunk_size=8)
s = score_clip(z["ref16"], z["dist16"], bit_depth=16, chunk_size=8)
out["16", "score_clip"] = (s.features, s.vmaf)
for model in ("vmaf_v0.6.1neg", "vmaf_4k_v0.6.1neg"):
    out["sharp", model] = stream_score(str(z["ref_sharp"]), str(z["dist_sharp"]),
                                       model=model, chunk_size=8)
with open(sys.argv[2], "wb") as fh:
    pickle.dump(out, fh)
"""

# The port's streamed runs, each in chunks of 4: (pair, model).
STREAM_RUNS = ([(pair, model) for pair in PAIRS for model in MODELS]
               + [("10", "vmaf_4k_v0.6.1"), ("sharp", "vmaf_v0.6.1neg"),
                  ("sharp", "vmaf_4k_v0.6.1neg"), ("sharp", "vmaf_v0.6.1")])


def _deep(x, depth, rng):
    """8-bit codes -> codes at ``depth``: x * 2^(depth-8) plus code noise
    in [0, 2^(depth-8)), so the content is off the 8-bit grid."""
    if depth == 8:
        return x.astype(np.uint8)
    s = 1 << (depth - 8)
    return (x.astype(np.int64) * s + rng.integers(0, s, x.shape)).astype(np.uint16)


def _scaled(codes, depth):
    """Codes as the pipeline hands them to the features: f32 on the 8-bit
    scale past 8 bits."""
    return (codes / float(1 << (depth - 8))).astype(np.float32)


def _smooth(seed, n, h, w, depth):
    """Smoothed random codes at ``depth`` and a blurred, noisy copy."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(16, 235, size=(n, h, w))
    for _ in range(2):
        base = (base + np.roll(base, 1, -1) + np.roll(base, -1, -1)
                + np.roll(base, 1, -2) + np.roll(base, -1, -2)) / 5.0
    s = 1 << (depth - 8)
    ref = np.round(base * s)
    b = (ref + np.roll(ref, 1, -1) + np.roll(ref, 1, -2)) / 3.0
    dist = np.clip(np.round(b) + rng.integers(-8 * s, 8 * s + 1, ref.shape), 0,
                   (1 << depth) - 1)
    return ref.astype(np.int64), dist.astype(np.int64)


def _edges(h, w, depth):
    """The largest codes: all-peak against all-0, and a 0/peak checkerboard
    of single pixels against its inverse."""
    peak = (1 << depth) - 1
    c1 = (np.indices((h, w)).sum(axis=0) % 2) * peak
    full, zero = np.full((h, w), peak, np.int64), np.zeros((h, w), np.int64)
    return np.stack([full, c1]), np.stack([zero, peak - c1])


def _frame_inputs(depth, h, w, seed):
    """Three smooth frames and the two edge frames at ``depth``: codes and
    their f32 8-bit-scale form."""
    r, d = _smooth(seed, 3, h, w, depth)
    er, ed = _edges(h, w, depth)
    r, d = np.concatenate([r, er]), np.concatenate([d, ed])
    return r, d, _scaled(r, depth), _scaled(d, depth)


def _planes(y, depth, rng):
    n, h, w = y.shape
    c = y.reshape(n, h // 2, 2, w // 2, 2).mean(axis=(2, 4)).round()
    yy, cc, vv = (_deep(p, depth, rng) for p in (y, c, 255 - c))
    return [{"y": yy[i], "u": cc[i], "v": vv[i]} for i in range(n)]


def _sharpened(ref, rng):
    """An enhanced copy: an unsharp mask plus +-2 noise, so VIF's and
    ADM's gain limits bite."""
    x = ref.astype(np.float64)
    b = (x + np.roll(x, 1, -1) + np.roll(x, -1, -1) + np.roll(x, 1, -2)
         + np.roll(x, -1, -2)) / 5.0
    return np.clip(np.round(x + 1.5 * (x - b)) + rng.integers(-2, 3, x.shape), 0,
                   255).astype(np.uint8)


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """(inputs and y4m paths, the JAX children's outputs, the port's
    ClipScores of STREAM_RUNS and of the 16-bit score_clip): the port runs
    while both children run."""
    import threading

    from pqa2_tpu_torch.pipeline.scoring import score_clip
    from pqa2_tpu_torch.pipeline.streaming import stream_score

    d = tmp_path_factory.mktemp("torch_depth")
    ref8, dist8 = _clip(N, seed=5)
    rng = np.random.default_rng(13)
    z = {}
    for depth in (8, 10, 12):
        for side, y in (("ref", ref8), ("dist", dist8)):
            path = d / f"{side}{depth}.y4m"
            write_y4m(str(path), _planes(y, depth, rng),
                      **({"colorspace": f"C420p{depth}"} if depth > 8 else {}))
            z[f"{side}_{depth}"] = str(path)
    for pair, (rd, dd) in PAIRS.items():
        z[f"ref_{pair}"], z[f"dist_{pair}"] = z[f"ref_{rd}"], z[f"dist_{dd}"]
    z["ref_sharp"], z["dist_sharp"] = z["ref_8"], str(d / "dist_sharp.y4m")
    write_y4m(z["dist_sharp"], _planes(_sharpened(ref8, rng), 8, rng))
    z["ref16"] = _scaled(_deep(ref8, 16, rng), 16)
    z["dist16"] = _scaled(_deep(dist8, 16, rng), 16)
    for depth in VIF_DEPTHS:
        (z[f"vif{depth}_r"], z[f"vif{depth}_d"], z[f"vif{depth}_r8"],
         z[f"vif{depth}_d8"]) = _frame_inputs(depth, 72, 96, depth)
    for depth in ADM_DEPTHS:
        # Odd sizes: halving as (n+1)//2 at every level.
        (z[f"adm{depth}_r"], z[f"adm{depth}_d"], z[f"adm{depth}_r8"],
         z[f"adm{depth}_d8"]) = _frame_inputs(depth, 71, 97, 100 + depth)
    out = {}

    def child(name, code):
        out[name] = jax_child(code, z, tmp_path_factory.mktemp(f"jax_{name}"))

    threads = [threading.Thread(target=child, args=a) for a in (("a", _JAX_A), ("b", _JAX_B))]
    for t in threads:
        t.start()
    port = {(pair, model): stream_score(z[f"ref_{pair}"], z[f"dist_{pair}"], model=model,
                                        chunk_size=CHUNK, device="cpu")
            for pair, model in STREAM_RUNS}
    port["16", "score_clip"] = score_clip(z["ref16"], z["dist16"], bit_depth=16,
                                          chunk_size=CHUNK, device="cpu")
    port["8", "score_clip"] = score_clip(ref8, dist8, chunk_size=CHUNK, device="cpu")
    for t in threads:
        t.join()
    assert set(out) == {"a", "b"}, "a JAX child failed (its assertion is above)"
    return z, {**out["a"], **out["b"]}, port


def _decoded_luma(path, depth):
    """A y4m file's luma on the 8-bit scale, as the pipeline hands it over."""
    from pqa2_tpu_torch.io.video import VideoReader

    with VideoReader(path) as r:
        return _scaled(np.stack([f["y"] for f in r]), depth)


@pytest.mark.parametrize("depth", VIF_DEPTHS)
def test_vif_twin_matches_jax_and_oracle(depth, cases):
    """Smooth frames and frames at the largest codes against the oracle (LUT
    accumulators and decimated planes at every scale, features); the
    exact features of the streamed 12-bit pair and the 16-bit clip equal
    to the JAX package's integer VIF in those runs; the fast statistic
    within 2e-6 of JAX's."""
    from pqa2_tpu.golden.vif_int import (
        _decimate,
        _statistic_pixel_terms,
        sigma_planes_int,
        vif_features_int,
    )
    from pqa2_tpu_torch.ops.vif_int import vif_features_int_batched, vif_int_scale_plain

    z, jax_out, _ = cases
    ref_c, dist_c = z[f"vif{depth}_r"], z[f"vif{depth}_d"]
    r8, d8 = z[f"vif{depth}_r8"], z[f"vif{depth}_d8"]
    # Integer stages, every scale: LUT accumulators and decimated planes.
    r, d = torch.from_numpy(ref_c.astype(np.int32)), torch.from_numpy(dist_c.astype(np.int32))
    ro, do = ref_c.astype(np.uint64), dist_c.astype(np.uint64)
    in_q = depth - 8
    for scale in range(4):
        taps = VIF_FILTERS_Q16[scale]
        stats, nr, nd, _ = vif_int_scale_plain(r, d, scale=scale, in_q=in_q,
                                               gain_limit=float("inf"), decimate=scale < 3)
        for i in range(ro.shape[0]):
            lb, nb, den_tab, k_den, num_tab, num_k, s2 = _statistic_pixel_terms(
                *sigma_planes_int(ro[i], do[i], taps, in_q), np.inf)
            flat = np.where(lb, 0, s2)
            want = [int(np.sum(np.where(nb, num_tab, 0))), int(np.sum(np.where(nb, num_k, 0))),
                    int(np.sum(np.where(lb, den_tab, 0))), int(np.sum(np.where(lb, k_den, 0))),
                    int(np.sum(lb)), int(np.sum(flat >> 16)), int(np.sum(flat & 0xFFFF))]
            assert stats[i].tolist() == want, (scale, i)
        if scale < 3:
            taps_next = VIF_FILTERS_Q16[scale + 1]
            ro = np.stack([_decimate(x, taps_next, in_q) for x in ro])
            do = np.stack([_decimate(x, taps_next, in_q) for x in do])
            np.testing.assert_array_equal(nr.numpy(), ro)
            np.testing.assert_array_equal(nd.numpy(), do)
            r, d, in_q = nr, nd, 8
    exact = vif_features_int_batched(torch.from_numpy(r8), torch.from_numpy(d8),
                                     bit_depth=depth).numpy()
    for i in range(ref_c.shape[0]):
        np.testing.assert_allclose(exact[i], vif_features_int(ref_c[i], dist_c[i],
                                                               bit_depth=depth),
                                   rtol=0, atol=VIF_ATOL)
    fast = vif_features_int_batched(torch.from_numpy(r8), torch.from_numpy(d8),
                                    bit_depth=depth, exact=False).numpy()
    np.testing.assert_allclose(fast, jax_out["vif_fast", depth], rtol=0, atol=VIF_ATOL)
    assert np.abs(fast - exact).max() > 0  # the two statistics differ
    # Exact: the JAX package's integer VIF on the clips it scored.
    if depth == 12:
        want = jax_out["12", "vmaf_v0.6.1"].features
        rl, dl = _decoded_luma(z["ref_12"], 12), _decoded_luma(z["dist_12"], 12)
    else:
        want = jax_out["16", "score_clip"][0]
        rl, dl = z["ref16"], z["dist16"]
    got = vif_features_int_batched(torch.from_numpy(rl), torch.from_numpy(dl),
                                   bit_depth=depth).numpy()
    for s in range(4):
        np.testing.assert_array_equal(got[:, s], want[f"vif_scale{s}"])


def test_adm_twin_matches_jax_and_oracle(cases):
    """At 10, 12 and 16 bits, gain 100 and 1.0 against the oracle, gain 100
    against JAX (each JAX ADM run here costs seconds of op compiles; the
    NEG models' runs below hold gain 1.0 to JAX); at 16 bits the edge
    frames drive level 0's row pass past 2^31 (the widened pass)."""
    from pqa2_tpu.golden.adm_int import adm_features_int, adm_pooled_digit_sums
    from pqa2_tpu_torch.golden.fixedpoint import DB2_HI_Q15, DB2_LO_Q15
    from pqa2_tpu_torch.ops.adm_int import (
        INT32_LIMIT,
        adm_cascade,
        adm_from_digit_sums,
        adm_level_plain,
        digits_from_sums,
        dwt1d_acc,
        level_codes,
        level_input,
    )

    z, jax_out, _ = cases
    for depth in ADM_DEPTHS:
        ref_c, dist_c = z[f"adm{depth}_r"], z[f"adm{depth}_d"]
        r8, d8 = torch.from_numpy(z[f"adm{depth}_r8"]), torch.from_numpy(z[f"adm{depth}_d8"])
        x0, drop = level_input(r8, depth)
        row = max(dwt1d_acc(level_codes(x0, 0, drop), f, -2).abs().max().item()
                  for f in (DB2_LO_Q15, DB2_HI_Q15))
        assert (row >= INT32_LIMIT) == (depth == 16), (depth, row)
        for gain in (100.0, 1.0):
            sums = adm_cascade(r8, d8, gain_limit=gain, bit_depth=depth,
                               level_fn=adm_level_plain)
            digits = digits_from_sums(sums)
            adm2 = adm_from_digit_sums(digits, *ref_c.shape[-2:])
            if gain == 100.0:
                want_digits, want_adm2 = jax_out["adm", depth]
                np.testing.assert_array_equal(digits, want_digits, err_msg=str(depth))
                np.testing.assert_allclose(adm2, want_adm2, rtol=0, atol=ADM_ATOL)
            for i in range(ref_c.shape[0]):
                np.testing.assert_array_equal(
                    digits[i], adm_pooled_digit_sums(ref_c[i], dist_c[i], gain, depth))
                assert adm2[i] == np.float32(adm_features_int(ref_c[i], dist_c[i], gain,
                                                              depth)[0]), (depth, gain, i)


def _assert_scores_match(got, want, family):
    """A port ClipScores against JAX's, with the module's budgets."""
    assert got.n_frames == want.n_frames and got.peak == want.peak
    for s in range(4):
        k = f"vif_scale{s}"
        if family == "integer":
            np.testing.assert_array_equal(got.features[k], want.features[k], err_msg=k)
        else:
            np.testing.assert_allclose(got.features[k], want.features[k], rtol=0,
                                       atol=FLOAT_ATOL, err_msg=k)
    np.testing.assert_allclose(got.features["adm2"], want.features["adm2"], rtol=0,
                               atol=ADM_ATOL if family == "integer" else FLOAT_ATOL)
    for k in ("motion", "motion2"):
        np.testing.assert_allclose(got.features[k], want.features[k], atol=0, err_msg=k,
                                   rtol=MOTION_RTOL if family == "integer"
                                   else FLOAT_MOTION_RTOL)
    np.testing.assert_allclose(got.vmaf, want.vmaf, rtol=0, atol=VMAF_ATOL[family])
    for k in want.psnr:
        if k.startswith("psnr"):
            np.testing.assert_allclose(got.psnr[k], want.psnr[k], rtol=0, atol=PSNR_ATOL,
                                       err_msg=k)
    for k in want.ssim:
        if k != "ssim_db":
            np.testing.assert_allclose(got.ssim[k], want.ssim[k], rtol=0, atol=SSIM_ATOL,
                                       err_msg=k)
    assert 0 < got.vmaf.min() and got.vmaf.max() <= 100


@pytest.mark.parametrize("model", list(MODELS))
def test_stream_score_deep_pairs_match_jax(model, cases):
    """10-bit, 12-bit and 8/10-bit pairs, chunk 4, PSNR+SSIM at the native
    peak."""
    _, jax_out, port = cases
    for pair, (rd, dd) in PAIRS.items():
        got = port[pair, model]
        assert got.peak == float((1 << max(rd, dd)) - 1) and got.model_name == model
        _assert_scores_match(got, jax_out[pair, model], MODELS[model])


def test_score_clip_16bit_matches_jax(cases):
    """16-bit luma on the 8-bit scale through score_clip (chunk 4; JAX's
    in one chunk, so it compiles one program): the integer family at
    in_q 8."""
    _, jax_out, port = cases
    got = port["16", "score_clip"]
    want_f, want_vmaf = jax_out["16", "score_clip"]
    for s in range(4):
        k = f"vif_scale{s}"
        np.testing.assert_array_equal(got.features[k], want_f[k], err_msg=k)
    np.testing.assert_allclose(got.features["adm2"], want_f["adm2"], rtol=0, atol=ADM_ATOL)
    for k in ("motion", "motion2"):
        np.testing.assert_allclose(got.features[k], want_f[k], rtol=MOTION_RTOL, atol=0)
    np.testing.assert_allclose(got.vmaf, want_vmaf, rtol=0, atol=VMAF_ATOL["integer"])
    # The 16-bit codes are the 8-bit clip's x 256 plus sub-code noise: its
    # motion stays within a code of the 8-bit clip's.
    eight = port["8", "score_clip"]
    assert np.all(got.vmaf > 0) and np.all(got.vmaf <= 100)
    np.testing.assert_allclose(got.features["motion"], eight.features["motion"], rtol=0,
                               atol=1.0)


def test_neg_and_4k_models_match_jax(cases):
    """vmaf_v0.6.1neg and vmaf_4k_v0.6.1neg (VIF and ADM at gain limit 1.0)
    on a sharpened 8-bit pair, vmaf_4k_v0.6.1 on the 10-bit pair, through
    stream_score."""
    _, jax_out, port = cases
    for pair, model in (("sharp", "vmaf_v0.6.1neg"), ("sharp", "vmaf_4k_v0.6.1neg"),
                        ("10", "vmaf_4k_v0.6.1")):
        got = port[pair, model]
        assert got.model_name == model
        _assert_scores_match(got, jax_out[pair, model], "integer")
    # The gain limits bite on the sharpened pair: the NEG features lie below
    # the default model's; the two NEG models share them, not their SVR.
    neg, default = port["sharp", "vmaf_v0.6.1neg"], port["sharp", "vmaf_v0.6.1"]
    for k in ("adm2", "vif_scale0"):
        assert np.all(neg.features[k] <= default.features[k]), k
        assert np.all(neg.features[k] < default.features[k] - 1e-3), k
    for k in FEATURES:
        np.testing.assert_array_equal(port["sharp", "vmaf_4k_v0.6.1neg"].features[k],
                                      neg.features[k])
    assert not np.allclose(port["sharp", "vmaf_4k_v0.6.1neg"].vmaf, neg.vmaf)
