"""The port's own copies of the framework-free modules equal the JAX package's.

pqa2_tpu_torch imports nothing of pqa2_tpu: it keeps copies of the numpy
oracles (``golden/``), the model loader and registry with the nine packaged
``data/*.npz`` files, the video readers (``io/``), two utilities and the
settings store (``app/options_manager.py``). Here
every copied constant and table is equal to the JAX package's, every copied
oracle gives the identical output on seeded inputs, every packaged model
loads to equal arrays, and the npz files are byte-identical. All exact: the
copies are the same numpy code.

Each test loops over its modules or models rather than being parametrised:
pytest-xdist's ``--dist loadfile`` queues files by their number of tests,
and a short file of few tests runs at the end of the queue, leaving the
order in which the JAX package's test files are handed out as it was
(ROADMAP Q1.0: those files fail or hang depending on which of them share a
worker process).
"""

import importlib
import json
import pathlib

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent

GOLDEN = ("filters", "fixedpoint", "log2lut", "vif_int", "motion_int", "adm",
          "adm_int", "ssim", "vif", "motion")
MODELS = ("vmaf_v0.6.1", "vmaf_v0.6.1neg", "vmaf_4k_v0.6.1", "vmaf_4k_v0.6.1neg",
          "vmaf_b_v0.6.3", "vmaf_float_v0.6.1", "vmaf_float_v0.6.1neg",
          "vmaf_float_4k_v0.6.1", "vmaf_float_b_v0.6.3")


def _both(name):
    return (importlib.import_module(f"pqa2_tpu.{name}"),
            importlib.import_module(f"pqa2_tpu_torch.{name}"))


def _equal(a, b, where):
    """Deep equality of constants: arrays, tuples, dicts, numbers."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _equal(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, where


def test_golden_constants_and_tables_equal():
    for mod in GOLDEN:
        _constants_equal(mod)


def _constants_equal(mod):
    jax_m, port_m = _both(f"golden.{mod}")
    # Public constants only: a private upper-case name such as log2lut's
    # _TABLE is a lazily filled cache, filled or not by whatever ran before
    # in the process; the tables themselves are compared through their
    # functions below.
    names = [k for k, v in vars(jax_m).items()
             if k.isupper() and not k.startswith("_")
             and isinstance(v, (int, float, tuple, dict, np.ndarray))]
    for k in names:
        _equal(getattr(jax_m, k), getattr(port_m, k), f"{mod}.{k}")
    if mod == "filters":
        for s in range(4):
            _equal(jax_m.vif_filter(s), port_m.vif_filter(s), f"vif_filter({s})")
        _equal(jax_m.motion_filter(), port_m.motion_filter(), "motion_filter")
    if mod == "log2lut":
        _equal(jax_m.log2_table(), port_m.log2_table(), "log2_table")
        _equal(jax_m.breakpoints_ext(), port_m.breakpoints_ext(), "breakpoints_ext")
    if mod == "adm":
        for lvl in range(4):
            _equal(jax_m.csf_rfactors(lvl), port_m.csf_rfactors(lvl), f"csf_rfactors({lvl})")
    # Every module the copy imports is a copy too.
    for k, v in vars(port_m).items():
        owner = getattr(v, "__module__", None) or ""
        assert not (owner == "pqa2_tpu" or owner.startswith("pqa2_tpu.")), (mod, k)


def _pair(seed, n, h, w):
    rng = np.random.default_rng(seed)
    base = rng.uniform(16, 235, size=(n, h, w))
    for _ in range(2):
        base = (base + np.roll(base, 1, -1) + np.roll(base, -1, -1)
                + np.roll(base, 1, -2) + np.roll(base, -1, -2)) / 5.0
    ref = np.round(base).astype(np.uint8)
    dist = np.clip(ref.astype(np.int64) + rng.integers(-8, 9, ref.shape), 0, 255)
    return ref, dist.astype(np.uint8)


ORACLES = {
    # name: (module, call on (ref, dist) frames (3, 40, 56))
    "vif_features[default]": ("vif", lambda m, r, d: m.vif_features(r[0], d[0])),
    "vif_features[classic,neg]": ("vif", lambda m, r, d: m.vif_features(
        r[0], d[0], gain_limit=1.0, variant="classic")),
    "adm_features": ("adm", lambda m, r, d: m.adm_features(r[0], d[0])),
    "motion_features": ("motion", lambda m, r, d: m.motion_features(r.astype(np.float64))),
    "vif_features_int": ("vif_int", lambda m, r, d: m.vif_features_int(r[1], d[1])),
    "adm_features_int": ("adm_int", lambda m, r, d: m.adm_features_int(r[1], d[1])),
    "motion_features_int": ("motion_int", lambda m, r, d: m.motion_features_int(r)),
    "ssim_plane": ("ssim", lambda m, r, d: m.ssim_plane(r[2], d[2])),
    "log2_q11": ("log2lut", lambda m, r, d: m.log2_q11(
        r.astype(np.uint64).ravel() * 4099 + 32768)),
}


def test_golden_oracles_identical():
    ref, dist = _pair(11, 3, 40, 56)
    for name, (mod, call) in ORACLES.items():
        jax_m, port_m = _both(f"golden.{mod}")
        _equal(call(jax_m, ref, dist), call(port_m, ref, dist), name)


def test_registry_models_equal():
    from pqa2_tpu_torch.models.registry import available_models

    assert set(MODELS) <= set(available_models())
    for name in MODELS:
        _model_equal(name)


def _model_equal(name):
    from pqa2_tpu.models.registry import get_model as jax_get
    from pqa2_tpu_torch.models.registry import get_model

    a, b = jax_get(name), get_model(name)
    assert type(a).__name__ == type(b).__name__ and b.name == name
    subs_a = a.models if hasattr(a, "models") else (a,)
    subs_b = b.models if hasattr(b, "models") else (b,)
    assert len(subs_a) == len(subs_b)
    for x, y in zip(subs_a, subs_b):
        for f in ("feature_names", "sv", "sv_coef", "slopes", "intercepts", "gamma",
                  "rho", "score_clip", "uses_integer_features"):
            _equal(getattr(x, f), getattr(y, f), f"{name}.{f}")
        for feat in x.feature_names:
            for key in ("vif_enhn_gain_limit", "adm_enhn_gain_limit"):
                assert x.feature_opt(feat, key, None) == y.feature_opt(feat, key, None)


def test_npz_files_byte_identical():
    src = sorted((ROOT / "pqa2_tpu" / "models" / "data").glob("*.npz"))
    dst = sorted((ROOT / "pqa2_tpu_torch" / "models" / "data").glob("*.npz"))
    assert [p.name for p in src] == [p.name for p in dst]
    assert len(dst) == len(MODELS) and {p.stem for p in dst} == set(MODELS)
    for a, b in zip(src, dst):
        assert a.read_bytes() == b.read_bytes(), a.name


def test_io_copies_read_and_write_the_same(tmp_path):
    from pqa2_tpu.io import video as jax_video
    from pqa2_tpu.io import y4m as jax_y4m
    from pqa2_tpu_torch.io import video, y4m

    ref, _ = _pair(12, 3, 36, 52)
    frames = [{"y": f, "u": f[::2, ::2], "v": 255 - f[::2, ::2]} for f in ref]
    jax_y4m.write_y4m(str(tmp_path / "j.y4m"), frames)
    y4m.write_y4m(str(tmp_path / "p.y4m"), frames)
    assert (tmp_path / "j.y4m").read_bytes() == (tmp_path / "p.y4m").read_bytes()
    assert video.probe_video(str(tmp_path / "p.y4m")) == jax_video.probe_video(
        str(tmp_path / "p.y4m"))
    r = video.VideoReader(str(tmp_path / "j.y4m"))
    try:
        got = [r.read_frame() for _ in range(3)]
        assert r.read_frame() is None
    finally:
        r.close()
    for g, f in zip(got, frames):
        for p in "yuv":
            np.testing.assert_array_equal(g[p], f[p])


def test_utils_copies():
    from pqa2_tpu_torch.utils.profiling import ThroughputMeter
    from pqa2_tpu_torch.utils.signals import Signal

    seen, progress = [], []
    s = Signal(int, name="x")
    s.connect(seen.append)
    s.emit(3)
    assert seen == [3]
    meter = ThroughputMeter(4, progress_cb=progress.append, min_interval_s=0.0)
    meter.add(2)
    meter.add(2)
    assert progress == [50, 100] and meter.fps > 0


def test_options_manager_copy(tmp_path):
    """The settings store: the same defaults, the same file read back the
    same way by both (old files backfilled with newer keys), and every
    method but the four device-discovery ones, which call the capture
    backends (app/devices.py) that the port does not have."""
    from pqa2_tpu.app import options_manager as jax_om
    from pqa2_tpu_torch.app import options_manager as port_om

    _equal(jax_om.default_settings(), port_om.default_settings(), "default_settings")
    left_out = {"get_decklink_devices", "get_decklink_formats", "test_device_connection",
                "get_ffmpeg_path"}
    jax_methods = {k for k in vars(jax_om.OptionsManager) if not k.startswith("__")}
    port_methods = {k for k in vars(port_om.OptionsManager) if not k.startswith("__")}
    assert port_methods == jax_methods - left_out
    old = {"vmaf": {"feature_precision": "integer_fast", "pool_method": "min"},
           "tpu": {"chunk_size": 8}}
    for name in ("jax", "port"):
        (tmp_path / f"{name}.json").write_text(json.dumps(old))
    a = jax_om.OptionsManager(str(tmp_path / "jax.json"), save_debounce_s=0)
    b = port_om.OptionsManager(str(tmp_path / "port.json"), save_debounce_s=0)
    _equal(a.get_settings(), b.get_settings(), "loaded settings")
    for m in (a, b):
        m.update_setting("vmaf", "feature_subsample", 2)
        m.flush()
    assert (tmp_path / "jax.json").read_text() == (tmp_path / "port.json").read_text()
    assert b.get_setting("vmaf", "feature_precision") == "integer_fast"
    assert b.get_setting("tpu", "chunk_size") == 8
    assert b.get_setting("tpu", "profile_dir") == a.get_setting("tpu", "profile_dir") == ""
