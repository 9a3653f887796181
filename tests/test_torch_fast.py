"""The port's ``precision="integer_fast"`` against the JAX package, on the CPU.

``integer_fast`` keeps the integer family's moments and sigma planes and
swaps VIF's LUT statistic for smooth f32 logs (``pqa2_tpu/ops/vif_int.py:
_statistic_fast``; kernel 1f in ``csrc/vif_int.cu``). Held here, through the
plain versions (CPU tensors):

  * the port's four-scale cascade against JAX ``vif_features_int_batched(
    exact=False)`` at 8, 10 and 16 bits and at gain limit inf and 1.0;
  * the same on 16-bit edge frames at the largest codes, where the sigma
    planes are largest: the JAX package casts them to int32, the port keeps
    int64, and both must give the same f32;
  * ``extract_features_batched(precision="integer_fast")`` on a chunk with
    both motion halos against JAX's.

The JAX side runs in one child interpreter (:func:`jax_child`) whose XLA
emits no FMA, as the slice tests' does (tests/test_torch_slice.py). Its
kernel-vs-plain checks on the card are the ``cuda`` tests of
tests/test_torch_ops.py.

Tolerances (each with its reason):
  vif_scale*     atol 2e-6 vs JAX: the JAX package's kernel-vs-twin budget
                 for the integer family (tests/test_pallas_int.py:20); the
                 per-pixel f32 operations are the same, log2 is the host
                 library's on each side and the sums run in another order
  adm2, motion   as tests/test_torch_slice.py (the integer stages are the
                 integer family's)

Keep this file below eight tests: pytest-xdist's ``--dist loadfile`` queues
files by their number of tests (ROADMAP Q1.0).
"""

import os
import pathlib
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent

VIF_ATOL = 2e-6
ADM_ATOL = 2e-6
MOTION_RTOL = 1e-6

DEPTHS = (8, 10, 16)
GAINS = (float("inf"), 1.0)
N, H, W = 5, 72, 96


def jax_child(code: str, inputs: dict, tmp: pathlib.Path):
    """Run ``code`` in a fresh interpreter on the CPU with the arrays of
    ``inputs`` (an npz, ``sys.argv[1]``); it pickles its result to
    ``sys.argv[2]``, which is returned. A child, because the JAX package's
    jitted pipelines leave state behind that can fail a later JAX
    ``stream_score`` in the same process (tests/test_torch_slice.py); its
    XLA emits no FMA (``--xla_cpu_max_isa=AVX``), so every f32 operation is
    rounded on its own as in the port."""
    src, out = tmp / "inputs.npz", tmp / "jax_out.pkl"
    np.savez(src, **inputs)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
    env["XLA_FLAGS"] = " ".join(
        f for f in (env.get("XLA_FLAGS"), "--xla_cpu_max_isa=AVX") if f)
    prelude = ("import pickle, sys\nimport numpy as np\n"
               "from pqa2_tpu.utils.stacklimit import raise_stack_limit\n"
               "raise_stack_limit()\nimport jax\n"
               "jax.config.update('jax_platforms', 'cpu')\nimport jax.numpy as jnp\n"
               "z = dict(np.load(sys.argv[1]))\n")
    proc = subprocess.run([sys.executable, "-c", prelude + code, str(src), str(out)],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out, "rb") as f:
        return pickle.load(f)


def _smooth(seed, n, h, w, depth):
    """Smoothed random codes in [0, 2^depth) and a noisy, blurred copy."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(16, 235, size=(n, h, w))
    for _ in range(2):
        base = (base + np.roll(base, 1, -1) + np.roll(base, -1, -1)
                + np.roll(base, 1, -2) + np.roll(base, -1, -2)) / 5.0
    s = 1 << (depth - 8)
    ref = np.round(base * s)
    b = (ref + np.roll(ref, 1, -1) + np.roll(ref, 1, -2)) / 3.0
    dist = np.clip(np.round(b) + rng.integers(-8 * s, 8 * s + 1, ref.shape), 0, (1 << depth) - 1)
    return ref.astype(np.int64), dist.astype(np.int64)


def _edges16(h, w):
    """16-bit codes, the largest: all-peak against all-0 and the reverse,
    and 0/peak checkerboards of single pixels and of 8x8 blocks (against
    their inverses and against a shifted copy), the frames whose sigma
    planes are largest. Five frames, as many as the smooth cases, so JAX
    compiles one program for both."""
    peak = (1 << 16) - 1
    yy, xx = np.indices((h, w))
    c1 = ((yy + xx) % 2) * peak
    c8 = ((yy // 8 + xx // 8) % 2) * peak
    full, zero = np.full((h, w), peak), np.zeros((h, w), np.int64)
    ref = np.stack([full, zero, c1, c8, c1])
    dist = np.stack([zero, full, peak - c1, peak - c8, np.roll(c1, 1, axis=0)])
    return ref, dist


def _scaled(codes, depth):
    """Codes as the pipeline hands them over: uint8 at 8 bits, else f32 on
    the 8-bit scale."""
    if depth == 8:
        return codes.astype(np.uint8)
    return (codes / float(1 << (depth - 8))).astype(np.float32)


def _inputs():
    out = {}
    for depth in DEPTHS:
        r, d = _smooth(depth, N, H, W, depth)
        out[f"smooth{depth}_r"], out[f"smooth{depth}_d"] = _scaled(r, depth), _scaled(d, depth)
    r, d = _edges16(H, W)
    out["edges16_r"], out["edges16_d"] = _scaled(r, 16), _scaled(d, 16)
    r, d = _smooth(7, 6, H, W, 8)
    out["chunk_r"], out["chunk_d"] = _scaled(r, 8), _scaled(d, 8)
    return out


_JAX = """
from pqa2_tpu.ops.vif_int import vif_features_int_batched
from pqa2_tpu.pipeline.features import extract_features_batched
out = {}
for key, depth in (("smooth8", 8), ("smooth10", 10), ("smooth16", 16), ("edges16", 16)):
    for gain in (float("inf"), 1.0):
        out[key, gain] = np.asarray(vif_features_int_batched(
            jnp.asarray(z[key + "_r"]), jnp.asarray(z[key + "_d"]), gain_limit=gain,
            bit_depth=depth, exact=False))
f = extract_features_batched(jnp.asarray(z["chunk_r"]), jnp.asarray(z["chunk_d"]),
                             has_prev=True, has_next=True, precision="integer_fast")
out["chunk"] = {k: np.asarray(v) for k, v in f.items()}
with open(sys.argv[2], "wb") as fh:
    pickle.dump(out, fh)
"""


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """(numpy inputs, the JAX package's outputs on them)."""
    inputs = _inputs()
    return inputs, jax_child(_JAX, inputs, tmp_path_factory.mktemp("torch_fast"))


def _port_vif(r, d, gain, depth):
    from pqa2_tpu_torch.ops.vif_int import vif_features_int_batched

    return vif_features_int_batched(torch.from_numpy(r), torch.from_numpy(d),
                                    gain_limit=gain, bit_depth=depth, exact=False).numpy()


@pytest.mark.parametrize("depth", DEPTHS)
def test_fast_cascade_matches_jax(cases, depth):
    """The plain fast statistic through all four scales, gain inf and 1.0,
    against JAX; and it is not the exact statistic's value."""
    from pqa2_tpu_torch.ops.vif_int import vif_features_int_batched

    inputs, want = cases
    r, d = inputs[f"smooth{depth}_r"], inputs[f"smooth{depth}_d"]
    for gain in GAINS:
        got = _port_vif(r, d, gain, depth)
        assert got.shape == (N, 4) and got.dtype == np.float32
        np.testing.assert_allclose(got, want[f"smooth{depth}", gain], rtol=0, atol=VIF_ATOL)
        exact = vif_features_int_batched(torch.from_numpy(r), torch.from_numpy(d),
                                         gain_limit=gain, bit_depth=depth).numpy()
        assert 0 < np.abs(got - exact).max() < 1e-3
    assert np.all(_port_vif(r, d, 1.0, depth) <= _port_vif(r, d, float("inf"), depth) + 1e-7)


def test_fast_cascade_16bit_largest_codes(cases):
    """16-bit edge frames: the sigma planes stay within int32 (the JAX
    package's cast), below 2^30 in magnitude, and the features match."""
    from pqa2_tpu_torch.golden.fixedpoint import VIF_FILTERS_Q16
    from pqa2_tpu_torch.ops.vif_int import _sigma_planes, to_native_grid

    inputs, want = cases
    r, d = inputs["edges16_r"], inputs["edges16_d"]
    codes_r, in_q = to_native_grid(torch.from_numpy(r), 16)
    codes_d, _ = to_native_grid(torch.from_numpy(d), 16)
    assert in_q == 8 and codes_r.max().item() == (1 << 16) - 1
    sig = _sigma_planes(codes_r.long(), codes_d.long(), VIF_FILTERS_Q16[0], in_q)
    big = max(s.abs().max().item() for s in sig)
    assert 2 ** 29 < big < 2 ** 30
    for gain in GAINS:
        got = _port_vif(r, d, gain, 16)
        assert np.all(np.isfinite(got))
        np.testing.assert_allclose(got, want["edges16", gain], rtol=0, atol=VIF_ATOL)


def test_extract_features_integer_fast_matches_jax(cases):
    """``extract_features_batched(precision="integer_fast")`` on a 6-frame
    chunk with both halos (4 core frames): the seven features against JAX's;
    ADM and motion are the integer family's."""
    from pqa2_tpu_torch.pipeline.features import extract_features_batched

    inputs, want = cases
    got = extract_features_batched(torch.from_numpy(inputs["chunk_r"]),
                                   torch.from_numpy(inputs["chunk_d"]), has_prev=True,
                                   has_next=True, precision="integer_fast")
    want = want["chunk"]
    assert set(got) == set(want)
    for k, v in got.items():
        assert v.shape == (4,) and v.dtype == torch.float32, k
    for s in range(4):
        k = f"vif_scale{s}"
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0, atol=VIF_ATOL)
    np.testing.assert_allclose(got["adm2"].numpy(), want["adm2"], rtol=0, atol=ADM_ATOL)
    for k in ("motion", "motion2"):
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=MOTION_RTOL, atol=0)
    assert np.all(got["motion"].numpy() > 0)
