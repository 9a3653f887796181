"""The port's own copies of the framework-free modules equal the JAX package's.

pqa2_tpu_torch imports nothing of pqa2_tpu: it keeps copies of the numpy
oracles (``golden/``), the model loader and registry with the nine packaged
``data/*.npz`` files, the video readers and the capture-file repair
(``io/``, the native frame pump's binding and its C++ source among them), three utilities (``signals``, ``profiling``'s meter, ``logs``), the
settings store (``app/options_manager.py``) and its options schema,
the report generator (``app/report_generator.py``), the results store, the
capture-device discovery and the capture manager (``app/results_store.py``,
``app/devices.py``, ``app/capture.py``), and the colorspace matrices. Here
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
          "adm_int", "ssim", "vif", "motion", "psnr")
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
    "psnr_frame": ("psnr", lambda m, r, d: m.psnr_frame(
        {"y": r[0], "u": r[1, ::2, ::2], "v": r[2, ::2, ::2]},
        {"y": d[0], "u": d[1, ::2, ::2], "v": r[2, ::2, ::2]})),
    "psnr_pooled": ("psnr", lambda m, r, d: m.psnr_pooled(
        [m.psnr_frame({p: a for p in "yuv"}, {p: b for p in "yuv"})
         for a, b in ((r[0], d[0]), (r[1], r[1]), (r[2], d[2]))])),
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


def test_io_copies_read_and_write_the_same(tmp_path, monkeypatch):
    from pqa2_tpu.io import native as jax_native
    from pqa2_tpu.io import video as jax_video
    from pqa2_tpu.io import y4m as jax_y4m
    from pqa2_tpu_torch.io import native, video, y4m

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

    # io/native.py: the C++ source is byte-equal to the JAX package's, and
    # the two bindings, over the port's build of it (so that nothing here
    # builds native/), read and write the same.
    assert (ROOT / "pqa2_tpu_torch" / "csrc" / "framepump.cpp").read_bytes() == (
        ROOT / "native" / "framepump.cpp").read_bytes()
    assert native.is_available()
    monkeypatch.setattr(jax_native, "_LIB_PATH", native._LIB_PATH)
    monkeypatch.setattr(jax_native, "_SRC_PATH", native._SRC_PATH)
    monkeypatch.setattr(jax_native, "_lib", None)
    assert jax_native.is_available()
    public = {k for k in vars(jax_native) if not k.startswith("_")}
    assert public <= set(vars(native)) and {"NativeY4MReader", "NativeY4MWriter"} <= public
    readers = [m.NativeY4MReader(str(tmp_path / "p.y4m")) for m in (jax_native, native)]
    try:
        attrs = ("width", "height", "fps_num", "fps_den", "bit_depth", "chroma_w",
                 "chroma_h", "frame_bytes", "fps")
        assert [getattr(readers[0], a) for a in attrs] == [getattr(readers[1], a) for a in attrs]
        a, b = readers[0].read_batch(2) + list(readers[0]), readers[1].read_batch(2) + list(
            readers[1])
    finally:
        for r in readers:
            r.close()
    assert len(a) == len(b) == 3
    for x, z in zip(a, b):
        for p in "yuv":
            assert x[p].dtype == z[p].dtype and x[p].tobytes() == z[p].tobytes()
    src = y4m.Y4MReader(str(tmp_path / "p.y4m"))
    header = y4m.header_line(src.header)
    src.close()
    for m, name in ((jax_native, "jn.y4m"), (native, "pn.y4m")):
        with m.NativeY4MWriter(str(tmp_path / name), header, readers[1].frame_bytes) as w:
            for f in frames:
                w.write_payload(np.concatenate([f[p].ravel() for p in "yuv"]))
    assert (tmp_path / "jn.y4m").read_bytes() == (tmp_path / "pn.y4m").read_bytes() == (
        tmp_path / "p.y4m").read_bytes()

    # io/repair.py: a capture cut mid-frame keeps its good prefix, and both
    # copies judge and salvage it the same way.
    from pqa2_tpu.io import repair as jax_repair
    from pqa2_tpu_torch.io import repair

    assert repair.MAX_REPAIR_ATTEMPTS == jax_repair.MAX_REPAIR_ATTEMPTS
    cut = tmp_path / "cut.y4m"
    cut.write_bytes((tmp_path / "p.y4m").read_bytes()[:-500])
    for path in (str(tmp_path / "p.y4m"), str(cut), str(tmp_path / "none.y4m")):
        assert repair.validate_video_file(path) == jax_repair.validate_video_file(path)
    assert repair.validate_video_file(str(cut)) and not repair.validate_video_file("")
    a = repair.repair_video_file(str(cut), str(tmp_path / "port_fixed.y4m"))
    b = jax_repair.repair_video_file(str(cut), str(tmp_path / "jax_fixed.y4m"))
    assert open(a, "rb").read() == open(b, "rb").read()
    assert video.probe_video(a)["frame_count"] == 2
    assert repair.repair_video_file(str(tmp_path / "none.y4m")) is None


def test_utils_copies(tmp_path, monkeypatch):
    """The utilities, and the report generator (app/report_generator.py,
    which reports through the signals): the same interpretation bands, and
    one results dict written through both packages' HTML and CSV writers
    gives the same files (the timestamp fixed in both)."""
    import datetime

    from pqa2_tpu.app import report_generator as jax_rg
    from pqa2_tpu_torch.app import report_generator as rg
    from pqa2_tpu_torch.utils.profiling import ThroughputMeter
    from pqa2_tpu_torch.utils.signals import Signal

    _logs_copy(tmp_path, monkeypatch)

    seen, progress = [], []
    s = Signal(int, name="x")
    s.connect(seen.append)
    s.emit(3)
    assert seen == [3]
    meter = ThroughputMeter(4, progress_cb=progress.append, min_interval_s=0.0)
    meter.add(2)
    meter.add(2)
    assert progress == [50, 100] and meter.fps > 0

    public = {k for k in vars(jax_rg) if not k.startswith("_")}
    assert public == {k for k in vars(rg) if not k.startswith("_")}
    for k in public:
        if k.isupper():
            _equal(getattr(jax_rg, k), getattr(rg, k), k)
    for fn in ("interpret_vmaf", "interpret_psnr", "interpret_ssim"):
        for v in (None, -1.0, 0.0, 0.69, 0.7, 0.8, 0.9, 0.95, 1.0, 19.9, 20, 30, 40,
                  59.99, 60, 70, 80, 90, 100.0, float("inf")):
            assert getattr(rg, fn)(v) == getattr(jax_rg, fn)(v), (fn, v)

    class FixedNow(datetime.datetime):
        @classmethod
        def now(cls, tz=None):
            return cls(2026, 1, 2, 3, 4, 5)

    for m in (jax_rg, rg):
        monkeypatch.setattr(m, "datetime", FixedNow)
    frames = [{"frameNum": i, "metrics": {"vmaf": 80.0 + i, "psnr_y": 40.5 - i,
                                          "float_ssim": 0.97, "adm2": 0.9 + i / 100}}
              for i in range(5)]
    frames[2]["metrics"]["psnr_y"] = float("inf")
    results = {"vmaf_score": 82.0, "psnr_score": float("inf"), "ssim_score": 0.97,
               "reference_video": "ref <a>.y4m", "distorted_video": "dist.y4m",
               "model": "vmaf_v0.6.1", "width": 96, "height": 64, "frame_count": 5,
               "raw_results": {"frames": frames}}
    assert rg._frame_series(results) == jax_rg._frame_series(results)
    assert rg.ReportGenerator()._summary_rows(results) == \
        jax_rg.ReportGenerator()._summary_rows(results)
    for name, m in (("jax", jax_rg), ("port", rg)):
        gen = m.ReportGenerator()
        assert gen.generate_html_report(results, str(tmp_path / f"{name}.html"))
        assert gen.export_csv(results, str(tmp_path / f"{name}.csv"))
    for ext in ("html", "csv"):
        assert (tmp_path / f"jax.{ext}").read_bytes() == (tmp_path / f"port.{ext}").read_bytes()
    assert "2026-01-02 03:04:05" in (tmp_path / "port.html").read_text()
    _app_copies(tmp_path, results)


def _logs_copy(tmp_path, monkeypatch):
    """utils/logs.py: the same functions, handlers, format and file name;
    only its directory (``~/.pqa2_tpu_torch``) and logger name differ."""
    import inspect
    import logging

    from pqa2_tpu.utils import logs as jax_logs
    from pqa2_tpu_torch.utils import logs

    public = {k for k in vars(jax_logs) if not k.startswith("_")}
    assert public == {k for k in vars(logs) if not k.startswith("_")}
    for fn in ("default_log_dir", "setup_logging"):
        assert inspect.signature(getattr(logs, fn)) == inspect.signature(getattr(jax_logs, fn))
    src = inspect.getsource(logs.setup_logging).replace('"pqa2_tpu_torch"', '"pqa2_tpu"')
    assert src == inspect.getsource(jax_logs.setup_logging)
    monkeypatch.setenv("APPDATA", str(tmp_path / "appdata"))
    assert logs.default_log_dir() == jax_logs.default_log_dir()
    monkeypatch.delenv("APPDATA")
    root = logging.getLogger()
    saved = (root.handlers[:], root.level)
    try:
        formats = []
        for name, m in (("jax", jax_logs), ("port", logs)):
            m.setup_logging(log_dir=str(tmp_path / f"logs_{name}"))
            formats.append([(type(h).__name__, h.formatter._fmt) for h in root.handlers])
            assert (tmp_path / f"logs_{name}" / "vmaf_app.log").exists()
        assert formats[0] == formats[1]
    finally:
        for h in root.handlers:
            if h not in saved[0]:
                h.close()
        root.handlers[:] = saved[0]
        root.setLevel(saved[1])


def _app_copies(tmp_path, results):
    """The results store, the capture-device discovery, the capture
    manager's constants, FileManager's paths and the colorspace matrices."""
    from pqa2_tpu.app import capture as jax_capture
    from pqa2_tpu.app import devices as jax_devices
    from pqa2_tpu.app import results_store as jax_store
    from pqa2_tpu.app import utils as jax_utils
    from pqa2_tpu.ops import colorspace as jax_cs
    from pqa2_tpu_torch.app import capture, devices, results_store, utils
    from pqa2_tpu_torch.ops import colorspace

    for jax_m, port_m in ((jax_store, results_store), (jax_devices, devices),
                          (jax_capture, capture)):
        public = {k for k in vars(jax_m) if not k.startswith("_")}
        assert public == {k for k in vars(port_m) if not k.startswith("_")}, port_m
        for k in public:
            if k.isupper():
                _equal(getattr(jax_m, k), getattr(port_m, k), f"{port_m.__name__}.{k}")
    assert capture._DEFAULT_REGISTRY == jax_capture._DEFAULT_REGISTRY
    assert [(s.name, s.value) for s in capture.CaptureState] == \
        [(s.name, s.value) for s in jax_capture.CaptureState]
    cmd = [(m.DeckLinkBackend(ffmpeg_path="ffmpeg").build_command(
        "Intensity Shuttle", 12.5, "out.mp4", {"disable_audio": True, "crf": 20}))
        for m in (jax_capture, capture)]
    assert cmd[0] == cmd[1]

    _equal(jax_devices.get_default_intensity_shuttle_formats(),
           devices.get_default_intensity_shuttle_formats(), "intensity shuttle formats")
    for code in (*devices.FORMAT_CODE_MAP, "nope"):
        assert devices.map_format_code(code) == jax_devices.map_format_code(code)
    assert devices.ffmpeg_path() == jax_devices.ffmpeg_path()
    assert devices.get_decklink_devices() == jax_devices.get_decklink_devices()
    assert devices.get_decklink_formats("DeckLink") == jax_devices.get_decklink_formats("DeckLink")
    assert devices.test_device_connection("DeckLink") == \
        jax_devices.test_device_connection("DeckLink")

    frames = [{"frameNum": i, "metrics": {"vmaf": float(i)}} for i in range(13)]
    for res in (results, {"vmaf_score": 50.0, "raw_results": {"frames": frames}}):
        metas = []
        for name, m in (("jax", jax_store), ("port", results_store)):
            d = tmp_path / f"meta_{name}_{len(res)}"
            d.mkdir()
            with open(m.write_compact_metadata(res, str(d), extra={"k": 1})) as f:
                metas.append({k: v for k, v in json.load(f).items() if k != "saved_at"})
        assert metas[0] == metas[1]

    fms = [m.FileManager(base_dir=str(tmp_path / "fm")) for m in (jax_utils, utils)]
    assert fms[0].get_test_dir("a b/c", "20260101_000000") == \
        fms[1].get_test_dir("a b/c", "20260101_000000")
    for fm in fms:
        fm.cleanup_temp_files()
    assert colorspace._KR_KB == jax_cs._KR_KB
    for st in colorspace._KR_KB:
        _equal(jax_cs._matrix(st), colorspace._matrix(st), f"colorspace._matrix({st})")


def test_options_manager_copy(tmp_path, monkeypatch):
    """The settings store: the same defaults, the same file read back the
    same way by both (old files backfilled with newer keys), the same
    methods, and the device-discovery ones giving the same answers."""
    from pqa2_tpu.app import options_manager as jax_om
    from pqa2_tpu_torch.app import options_manager as port_om

    _equal(jax_om.default_settings(), port_om.default_settings(), "default_settings")
    jax_methods = {k for k in vars(jax_om.OptionsManager) if not k.startswith("__")}
    port_methods = {k for k in vars(port_om.OptionsManager) if not k.startswith("__")}
    assert port_methods == jax_methods
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
    _options_schema_copy()
    for name in ("get_decklink_devices", "get_ffmpeg_path"):
        assert getattr(b, name)() == getattr(a, name)(), name
    for name in ("get_decklink_formats", "test_device_connection"):
        assert getattr(b, name)("Intensity Shuttle") == getattr(a, name)("Intensity Shuttle")
    from pqa2_tpu.io import ffmpeg_pipe as jax_pipe
    from pqa2_tpu_torch.io import ffmpeg_pipe

    for pipe in (jax_pipe, ffmpeg_pipe):  # a configured path is installed there
        monkeypatch.setattr(pipe, "_configured", dict(pipe._configured))
    monkeypatch.delenv("PQA2_FFMPEG", raising=False)
    for m in (a, b):
        m.update_setting("paths", "ffmpeg_path", str(tmp_path / "ffmpeg"))
    assert b.get_ffmpeg_path() == a.get_ffmpeg_path() == str(tmp_path / "ffmpeg")
    assert ffmpeg_pipe.resolve_ffmpeg() == jax_pipe.resolve_ffmpeg() == str(tmp_path / "ffmpeg")


def _options_schema_copy():
    """ui/controllers/options_schema.py: the same fields (keys, kinds,
    bounds, tabs) in the same order, so one settings file binds in both;
    only the labels of the ``tpu`` category differ."""
    import dataclasses

    from pqa2_tpu.ui.controllers import options_schema as jax_schema
    from pqa2_tpu_torch.ui.controllers import options_schema as schema

    assert schema.TABS == jax_schema.TABS
    assert len(schema.FIELDS) == len(jax_schema.FIELDS)
    for a, b in zip(jax_schema.FIELDS, schema.FIELDS):
        da, db = dataclasses.asdict(a), dataclasses.asdict(b)
        if a.category != "tpu":
            assert da == db, (da, db)
        da.pop("label"), db.pop("label")
        assert da == db, (da, db)
    for tab in schema.TABS:
        assert [(f.category, f.key) for f in schema.fields_for_tab(tab)] == \
            [(f.category, f.key) for f in jax_schema.fields_for_tab(tab)]
