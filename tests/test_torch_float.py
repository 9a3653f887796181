"""The port's float feature family against the JAX package and the oracles.

Each plain PyTorch module of the float path (``ops/filters`` and
``ops/vif`` here; ``ops/adm``, ``ops/motion`` and the float chain's pins in
tests/test_torch_float_adm_motion.py) and each of its kernels' wrappers on
CPU tensors is held against:

  * the JAX package's XLA twin on the CPU, the plain reference its own tests
    pin the Pallas kernels to (tests/test_pallas.py). It is compiled with
    ``xla_backend_optimization_level=0``: at its default level XLA's CPU
    backend contracts f32 multiply-adds into FMAs (``xx - mu*mu`` among
    them), which the JAX source does not ask for and which moves the small
    scales' VIF by more than these tolerances; at level 0 every f32
    operation is rounded on its own as written, as in the port and its CUDA
    kernels;
  * the float64 oracles of ``pqa2_tpu/golden``, and the float chain's
    checked-in pins (tests/goldens/regression_golden.json).

Inputs are made from a numpy seed: 3 frames of 72x96 and one odd 71x97 case.
Keep this file and tests/test_torch_float_adm_motion.py below eight tests
each: pytest-xdist's ``--dist loadfile`` queues files by their number of
tests, so they run after every file of the JAX package whose order matters
(ROADMAP Q1.0: those files fail or hang depending on which of them share a
worker process).

Tolerances (each with its reason):
  sep_filter_batched, dwt2_batched   atol 1e-4 on the 8-bit scale: f32 in the
                                     same tap order (they come out equal)
  vif features (classic/default, gain inf/1.0), per scale
                                     atol 5e-5 vs the twin: the same per-pixel
                                     f32, sums in another order; inside the
                                     JAX package's kernel-vs-twin 2e-4
                                     (test_pallas.py:60). Per scale the ratio
                                     is held, not the num/den totals, which
                                     differ by up to 3e-5 relative (XLA's CPU
                                     reduction adds in another order)
  adm2 (gain 100, 1.0)               atol 5e-5 vs the twin, inside 3e-4
                                     (test_pallas.py:140)
  motion, motion2                    rtol 1e-5: the f32 mean of the same
                                     blurred values
  vs the float64 oracles             vif 2e-4, adm2 2e-4, motion 2e-3, the JAX
                                     package's own budgets (tests/test_ops.py)
"""

import numpy as np
import pytest
import torch

from pqa2_tpu.golden import vif as gold_vif
from pqa2_tpu.golden.filters import motion_filter, vif_filter

try:
    import jax
    import jax.numpy as jnp
except ImportError:  # the card's machine: only the cuda tests of test_torch_ops run
    jax = jnp = None

FILTER_ATOL = 1e-4
VIF_ATOL = 5e-5
ADM_ATOL = 5e-5
MOTION_RTOL = 1e-5
ORACLE_VIF = 2e-4
ORACLE_ADM = 2e-4
ORACLE_MOTION = 2e-3

SHAPES = {"72x96": (3, 72, 96), "71x97": (3, 71, 97)}
VIF_CASES = [("classic", float("inf")), ("classic", 1.0), ("default", float("inf")),
             ("default", 1.0)]


def _pair(shape, seed=1):
    rng = np.random.default_rng(seed)
    n, h, w = shape
    base = rng.uniform(16, 235, size=(h + 2 * n, w + 2 * n))
    for _ in range(2):
        base = (base + np.roll(base, 1, -1) + np.roll(base, -1, -1)
                + np.roll(base, 1, -2) + np.roll(base, -1, -2)) / 5.0
    ref = np.stack([base[t: t + h, 2 * t: 2 * t + w] for t in range(n)])
    ref = np.round(ref)
    b = ref.copy()
    b = (b + np.roll(b, 1, -1) + np.roll(b, -1, -1) + np.roll(b, 1, -2)
         + np.roll(b, -1, -2)) / 5.0
    dist = np.clip(np.round(b) + rng.integers(-8, 9, ref.shape), 0, 255)
    return ref.astype(np.float32), dist.astype(np.float32)


def _twin(fn, *static):
    """The JAX function jitted with every f32 operation rounded on its own."""
    return jax.jit(fn, static_argnames=static,
                   compiler_options={"xla_backend_optimization_level": 0})


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


# -- filters -------------------------------------------------------------------

def test_sep_filter_and_dwt_match_jax():
    for shape in SHAPES:
        _filters_match(shape)


def _filters_match(shape):
    from pqa2_tpu.ops import filters as jf
    from pqa2_tpu_torch.ops import filters as tf

    ref, _ = _pair(SHAPES[shape])
    for taps in (vif_filter(0), vif_filter(3), motion_filter()):
        for mode in ("reflect", "symmetric"):
            got = tf.sep_filter_batched(_t(ref), taps, mode).numpy()
            want = np.asarray(_twin(lambda x: jf.sep_filter_batched(x, taps, mode))(
                jnp.asarray(ref)))
            np.testing.assert_allclose(got, want, rtol=0, atol=FILTER_ATOL)
    got = tf.dwt2_batched(_t(ref))
    want = _twin(jf.dwt2_batched)(jnp.asarray(ref))
    n, h, w = SHAPES[shape]
    for b in "ahvd":
        assert got[b].shape == (n, (h + 1) // 2, (w + 1) // 2)
        np.testing.assert_allclose(got[b].numpy(), np.asarray(want[b]), rtol=0,
                                   atol=FILTER_ATOL)


# -- VIF -----------------------------------------------------------------------

def _jax_scale(ref, dist, scale, gain_limit, variant):
    from pqa2_tpu.ops import filters as jf
    from pqa2_tpu.ops import vif as jv

    stat = jv._statistic_default if variant == "default" else jv._statistic_classic
    num, den = stat(*jv._moments(ref, dist, vif_filter(scale)), gain_limit)
    nxt = None
    if scale < 3:
        nxt = tuple(jf.sep_filter_batched(x, vif_filter(scale + 1))[:, ::2, ::2]
                    for x in (ref, dist))
    return num, den, nxt


@pytest.mark.parametrize("variant", ["classic", "default"])
def test_vif_per_scale_matches_jax(variant):
    """Each scale of the plain kernel contract against the twin's scale on
    the twin's own inputs, gain inf and 1.0: num/den and the decimated
    planes."""
    for gain in (float("inf"), 1.0):
        _vif_per_scale(variant, gain)


def _vif_per_scale(variant, gain):
    from pqa2_tpu_torch.ops.vif import vif_ratio, vif_scale_plain

    ref, dist = _pair(SHAPES["72x96"])
    jr, jd = jnp.asarray(ref), jnp.asarray(dist)
    scale_fn = _twin(_jax_scale, "scale", "gain_limit", "variant")
    for scale in range(4):
        jnum, jden, jnext = scale_fn(jr, jd, scale=scale, gain_limit=gain, variant=variant)
        num, den, nr, nd = vif_scale_plain(_t(np.asarray(jr)), _t(np.asarray(jd)),
                                           scale=scale, gain_limit=gain,
                                           variant=variant, emit_next=scale < 3)
        np.testing.assert_allclose(
            vif_ratio(num, den).numpy(), np.asarray(jnum) / np.asarray(jden),
            rtol=0, atol=VIF_ATOL)
        if scale < 3:
            for got, want in zip((nr, nd), jnext):
                np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                           atol=FILTER_ATOL)
            jr, jd = jnext
        else:
            assert nr is None and nd is None


@pytest.mark.parametrize("shape", list(SHAPES))
def test_vif_features_match_jax_and_oracle(shape):
    """Both statistics at gain inf and 1.0 on the 72x96 frames; the float
    models' case (classic, NEG gain 1.0) on the odd 71x97 frames."""
    for variant, gain in VIF_CASES if shape == "72x96" else [("classic", 1.0)]:
        _vif_features(shape, variant, gain)


def _vif_features(shape, variant, gain):
    from pqa2_tpu.ops import vif as jv
    from pqa2_tpu_torch.ops import cuda_vif
    from pqa2_tpu_torch.ops.vif import vif_features_batched

    ref, dist = _pair(SHAPES[shape])
    got = vif_features_batched(_t(ref), _t(dist), gain, variant).numpy()
    want = np.asarray(_twin(jv.vif_features_batched, "gain_limit", "variant")(
        jnp.asarray(ref), jnp.asarray(dist), gain_limit=gain, variant=variant))
    np.testing.assert_allclose(got, want, rtol=0, atol=VIF_ATOL)
    # The wrapper's cascade (plain version on CPU tensors) is the same.
    wrapped, sad = cuda_vif.vif_features(_t(ref), _t(dist), gain_limit=gain,
                                         variant=variant)
    np.testing.assert_array_equal(wrapped.numpy(), got)
    assert sad is None
    for i in range(ref.shape[0]):
        oracle = gold_vif.vif_features(ref[i], dist[i], gain_limit=gain, variant=variant)
        np.testing.assert_allclose(got[i], oracle, rtol=0, atol=ORACLE_VIF)
    if gain == 1.0:  # the NEG clamp bites at some scale
        unclamped = vif_features_batched(_t(ref), _t(dist), float("inf"), variant).numpy()
        assert not np.array_equal(got, unclamped)


def test_float_wrappers_use_plain_versions_on_cpu():
    from pqa2_tpu_torch.ops import adm, cuda_adm, cuda_motion, cuda_vif, motion, vif

    ref, dist = _pair((3, 40, 56))
    r, d = _t(ref), _t(dist)
    before = (cuda_vif.vif_scale.launches, cuda_adm.adm_level.launches,
              cuda_motion.motion_sad.launches)
    got = cuda_vif.vif_scale(r, d, scale=0, gain_limit=1.0, variant="classic",
                             emit_next=True, motion_ref=r)
    want = vif.vif_scale_plain(r, d, scale=0, gain_limit=1.0, variant="classic",
                               emit_next=True)
    for a, b in zip(got[:4], want):
        assert torch.equal(a, b)
    assert torch.equal(got[4], motion.motion_sad_plain(r))
    for a, b in zip(cuda_adm.adm_level(r, d, level=0, gain_limit=100.0),
                    adm.adm_level_plain_float(r, d, level=0, gain_limit=100.0)):
        assert torch.equal(a, b)
    # No kernel was launched: the CPU path is not counted.
    assert before == (cuda_vif.vif_scale.launches, cuda_adm.adm_level.launches,
                      cuda_motion.motion_sad.launches)
