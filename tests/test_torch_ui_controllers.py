"""The port's Qt-free UI controllers (``pqa2_tpu_torch.ui.controllers``, and
``ui.branding``) held to the JAX package's on the same inputs.

Each of the 25 cases below runs one scenario of tests/test_ui_controllers.py
(the history browser over a real ``ResultsStore``, device status, the
capture log, the options schema's binding and round trip, the setup
helpers, the preview pipeline, format detection and the branding logo),
plus the package's exported names, once on each package's own modules.
Every assertion of the original scenario holds for both, and the two give
equal results (paths compared relative to each run's directory).

The cases are grouped into seven tests, each looping over its cases:
pytest-xdist's ``--dist loadfile`` queues files by their number of tests
(ROADMAP Q1.0), so the file stays below eight.
"""

import csv
import importlib
import json
import os
import types

import numpy as np

PACKAGES = ("pqa2_tpu", "pqa2_tpu_torch")


def _ns(pkg):
    """The modules a scenario runs on, all of one package."""
    m = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    return types.SimpleNamespace(
        pkg=pkg, ctl=m("ui.controllers"), capturelog=m("ui.controllers.capturelog"),
        devicestatus=m("ui.controllers.devicestatus"), preview=m("ui.controllers.preview"),
        schema=m("ui.controllers.options_schema"), formats=m("ui.controllers.formats"),
        branding=m("ui.branding"), store=m("app.results_store"), om=m("app.options_manager"),
        capture=m("app.capture"), y4m=m("io.y4m"))


def _both(cases, tmp_path):
    """Run every case on both packages; each case's results must be equal."""
    for name, case in cases.items():
        outs = []
        for pkg in PACKAGES:
            d = tmp_path / pkg / name
            d.mkdir(parents=True)
            outs.append(case(_ns(pkg), str(d)))
        assert outs[0] == outs[1], (name, outs)


def _results(vmaf=97.5, frames=12):
    return {
        "vmaf_score": vmaf, "psnr_score": 38.0, "ssim_score": 0.98,
        "model": "vmaf_v0.6.1", "width": 1920, "height": 1080,
        "frame_count": frames,
        "reference_video": "ref.y4m", "distorted_video": "dist.y4m",
        "raw_results": {"frames": [
            {"frameNum": i, "metrics": {"vmaf": vmaf}} for i in range(frames)
        ]},
    }


# -- history ----------------------------------------------------------------------


def _history_refresh_and_labels(ns, d):
    store = ns.store.ResultsStore(d)
    store.save(_results(88.25), "testA", timestamp="20260101_010101")
    store.save(_results(55.0), "testB", timestamp="20260202_020202")
    rows = ns.ctl.HistoryController(store).refresh()
    assert len(rows) == 2
    assert rows[0]["test_name"].startswith("testB")
    assert "VMAF 55.00" in rows[0]["label"] and "1920x1080" in rows[0]["label"]
    assert "vmaf_v0.6.1" in rows[0]["label"]
    return [(r["label"], os.path.relpath(r["test_dir"], d)) for r in rows]


def _history_view_prefers_metadata(ns, d):
    store = ns.store.ResultsStore(d)
    t = store.save(_results(91.0), "t", timestamp="20260101_000000")
    res, msg = ns.ctl.HistoryController(store).view(t)
    assert res["vmaf_score"] == 91.0 and msg == "loaded metadata"
    return {k: v for k, v in res.items() if k != "saved_at"}, msg


def _history_view_rebuilds_from_vmaf_json(ns, d):
    t = os.path.join(d, "bare_20260101_000000")
    os.makedirs(t)
    with open(os.path.join(t, "x_vmaf.json"), "w") as f:
        json.dump({"pooled_metrics": {"vmaf": {"mean": 77.7}}, "frames": []}, f)
    res, msg = ns.ctl.HistoryController(ns.store.ResultsStore(d)).view(t)
    assert res["vmaf_score"] == 77.7 and msg == "rebuilt from vmaf json"
    assert res["json_path"].endswith("x_vmaf.json")
    return dict(res, json_path=os.path.relpath(res["json_path"], d)), msg


def _history_view_missing(ns, d):
    empty = os.path.join(d, "empty")
    os.makedirs(empty)
    res, msg = ns.ctl.HistoryController(ns.store.ResultsStore(d)).view(empty)
    assert res is None and "no VMAF results" in msg
    return res, msg.replace(d, "")


def _history_delete_and_containment(ns, d):
    store = ns.store.ResultsStore(os.path.join(d, "base"))
    d1 = store.save(_results(), "a", timestamp="20260101_000001")
    d2 = store.save(_results(), "b", timestamp="20260101_000002")
    outside = os.path.join(d, "outside")
    os.makedirs(outside)
    hc = ns.ctl.HistoryController(store)
    n, failures = hc.delete([d1, outside])
    assert n == 1 and len(failures) == 1 and "outside" in failures[0]
    assert os.path.isdir(outside) and not os.path.isdir(d1)
    assert [r["test_dir"] for r in hc.rows] == [d2]
    return n, [f.replace(d, "") for f in failures]


def _history_combined_export(ns, d):
    store = ns.store.ResultsStore(d)
    store.save(_results(80.0), "x", timestamp="20260101_000001")
    store.save(_results(60.0), "y", timestamp="20260101_000002")
    out = ns.ctl.HistoryController(store).export_combined(os.path.join(d, "hist.csv"))
    with open(out) as f:
        rows = list(csv.reader(f))
    assert rows[0][0] == "test_name" and len(rows) == 3
    return rows


def test_history(tmp_path):
    _both({"refresh_and_labels": _history_refresh_and_labels,
           "view_prefers_metadata": _history_view_prefers_metadata,
           "view_rebuilds_from_vmaf_json": _history_view_rebuilds_from_vmaf_json,
           "view_missing": _history_view_missing,
           "delete_and_containment": _history_delete_and_containment,
           "combined_export": _history_combined_export}, tmp_path)


# -- device status ------------------------------------------------------------------


class _FakeOM:
    def __init__(self, devices=None, default=None, result=(True, "ok"),
                 raise_on_check=False):
        self._devices = devices
        self._default = default
        self._result = result
        self._raise = raise_on_check

    def get_decklink_devices(self):
        return self._devices

    def get_setting(self, cat, key=None):
        return self._default if key == "default_device" else None

    def test_device_connection(self, name):
        if self._raise:
            raise RuntimeError("probe exploded")
        return self._result


def _device_rows_probe_and_default(ns, d):
    out = ns.ctl.device_rows(_FakeOM(devices=["DeckLink 4K", "UltraStudio"],
                                     default="UltraStudio"))
    assert out == (["DeckLink 4K", "UltraStudio"], "UltraStudio")
    return out


def _device_rows_fallback_list(ns, d):
    devices, current = ns.ctl.device_rows(_FakeOM(devices=[]))
    assert devices == ns.devicestatus.FALLBACK_DEVICES and current is None
    return devices, current


def _device_status_levels(ns, d):
    check = ns.ctl.check_device_status
    ok = check("DeckLink", _FakeOM(result=(True, "signal ok")))
    assert (ok.level, ok.color) == ("connected", "#00AA00") and "connected" in ok.tooltip
    bad = check("DeckLink", _FakeOM(result=(False, "no card")))
    assert (bad.level, bad.color) == ("unavailable", "#AA0000")
    assert "not connected" in bad.tooltip
    none_sel = check("", _FakeOM())
    no_om = check("DeckLink", None)
    err = check("DeckLink", _FakeOM(raise_on_check=True))
    assert none_sel.level == no_om.level == err.level == "unknown"
    assert "probe exploded" in err.message
    return [(s.level, s.color, s.tooltip, s.message) for s in (ok, bad, none_sel, no_om, err)]


def test_device_status(tmp_path):
    _both({"rows_probe_and_default": _device_rows_probe_and_default,
           "rows_fallback_list": _device_rows_fallback_list,
           "status_levels": _device_status_levels}, tmp_path)


# -- capture log ----------------------------------------------------------------------


def _log_classification(ns, d):
    classify = ns.capturelog.classify
    out = [classify(m) for m in ("Capture failed: timeout", "WARNING: dropped frame",
                                 "Capture complete", "Starting device...")]
    assert out == ["error", "warning", "success", "info"]
    return out


def _log_entries_and_html(ns, d):
    log = ns.ctl.CaptureLogModel(max_entries=3, clock=lambda: "12:00:00")
    seen, via_signal = [], []
    log.on_entry(seen.append)
    log.entry_added.connect(via_signal.append)
    log.add("Starting")
    e = log.add("Capture failed: no signal")
    assert e.severity == "error" and e.text == "[12:00:00] Capture failed: no signal"
    assert "#D32F2F" in e.html and "bold" in e.html and log.has_errors
    assert len(seen) == 2 and len(via_signal) == 2 and via_signal[-1].severity == "error"
    log.add("a")
    log.add("b")
    assert len(log.entries) == 3 and log.tail(2)[-1].message == "b"
    return [(x.severity, x.text, x.html) for x in log.entries]


def _log_attach_to_capture_manager(ns, d):
    n, h, w = 3, 32, 48
    frames = [{"y": np.full((h, w), 64, np.uint8),
               "u": np.full((h // 2, w // 2), 128, np.uint8),
               "v": np.full((h // 2, w // 2), 128, np.uint8)} for _ in range(n)]
    ref = os.path.join(d, "ref.y4m")
    ns.y4m.write_y4m(ref, frames)
    cm = ns.capture.CaptureManager(backend=ns.capture.FilePlaybackBackend())
    cm.set_output_directory(d)
    cm.set_reference_video({"path": ref, "duration": n / 30.0, "frame_rate": 30.0})
    log = ns.ctl.CaptureLogModel(clock=lambda: "00:00:00")
    log.attach(cm)
    counts = []
    cm.frame_count_updated.connect(lambda k, t: counts.append((k, t)))
    assert cm.start_bookend_capture("Fake Device")
    assert cm.wait(timeout=60)
    msgs = [e.message for e in log.entries]
    assert any("Capturing" in m for m in msgs)
    assert any(m.startswith("Capture finished successfully") for m in msgs)
    assert counts and counts[-1][0] > 0 and counts[-1][1] >= counts[-1][0] - 10
    return [e.severity for e in log.entries], counts[-1]


def test_capture_log(tmp_path):
    _both({"classification": _log_classification,
           "entries_and_html": _log_entries_and_html,
           "attach_to_capture_manager": _log_attach_to_capture_manager}, tmp_path)


# -- options schema ---------------------------------------------------------------------


def _schema_keys_exist_in_defaults(ns, d):
    tree = ns.om.default_settings()
    for f in ns.schema.FIELDS:
        assert f.category in tree and f.key in tree[f.category], (f.category, f.key)
    return [(f.category, f.key) for f in ns.schema.FIELDS]


def _schema_load_save_roundtrip(ns, d):
    om = ns.om.OptionsManager(settings_file=os.path.join(d, "s.json"), save_debounce_s=0)
    values = ns.schema.load_values(om)
    assert values[("bookend", "white_threshold")] == 200
    assert values[("vmaf", "feature_precision")] == "auto"
    assert values[("capture", "pixel_format")] == "uyvy422"
    loaded = sorted(values.items())
    values[("bookend", "white_threshold")] = 222
    values[("vmaf", "feature_precision")] = "float"
    fr_field = next(f for f in ns.schema.fields_for_tab("Capture") if f.key == "frame_rate")
    values[("capture", "frame_rate")] = ns.schema.coerce(fr_field, "25")
    ns.schema.save_values(om, values)
    assert om.get_setting("bookend", "white_threshold") == 222
    assert om.get_setting("vmaf", "feature_precision") == "float"
    assert om.get_setting("capture", "frame_rate") == 25.0
    assert om.get_setting("bookend", "min_loops") == 3
    om.flush()
    with open(os.path.join(d, "s.json")) as f:
        return loaded, json.load(f)


def _schema_coerce_kinds(ns, d):
    by = {(f.category, f.key): f for f in ns.schema.FIELDS}
    coerce = ns.schema.coerce
    out = [coerce(by[("bookend", "white_threshold")], 200.0),
           coerce(by[("bookend", "bookend_duration")], "0.3"),
           coerce(by[("capture", "disable_audio")], 1),
           coerce(by[("encoder", "default_preset")], "fast"),
           coerce(by[("capture", "frame_rate")], "29.97"),
           coerce(by[("tpu", "chunk_size")], 16.0)]
    assert out[0] == 200 and isinstance(out[1], float) and out[2] is True
    assert out[3] == "fast"
    return [(type(v).__name__, v) for v in out]


def _schema_tabs_cover_all_fields(ns, d):
    covered = [f for t in ns.schema.TABS for f in ns.schema.fields_for_tab(t)]
    assert len(covered) == len(ns.schema.FIELDS)
    keys = [(f.category, f.key) for f in ns.schema.FIELDS]
    assert len(keys) == len(set(keys))
    return ns.schema.TABS, [(f.tab, f.category, f.key) for f in covered]


def test_options_schema(tmp_path):
    _both({"keys_exist_in_defaults": _schema_keys_exist_in_defaults,
           "load_save_roundtrip": _schema_load_save_roundtrip,
           "coerce_kinds": _schema_coerce_kinds,
           "tabs_cover_all_fields": _schema_tabs_cover_all_fields}, tmp_path)


# -- setup --------------------------------------------------------------------------------


def _parse_duration(ns, d):
    out = [ns.ctl.parse_duration(t) for t in ("Full duration", "5s", "60s", "", "garbage",
                                              *ns.ctl.DURATION_CHOICES)]
    assert out[:5] == [None, 5.0, 60.0, None, None]
    return out


def _reference_summary(ns, d):
    info = {"width": 1920, "height": 1080, "frame_rate": 29.97, "duration": 10.0,
            "frame_count": 300, "pix_fmt": "yuv420p", "codec": "rawvideo",
            "has_bookends": True}
    lines = ns.ctl.reference_summary(info)
    assert lines[0] == "Resolution: 1920x1080" and "29.970 fps" in lines[1]
    assert lines[-1].endswith("yes")
    info["bit_depth"] = 10
    deep = ns.ctl.reference_summary(info)
    assert any("10-bit" in line for line in deep)
    return lines, deep


def _load_preview_rgb(ns, d):
    h, w = 32, 48
    frames = [{"y": np.full((h, w), 40 * (i + 1), np.uint8),
               "u": np.full((h // 2, w // 2), 128, np.uint8),
               "v": np.full((h // 2, w // 2), 128, np.uint8)} for i in range(3)]
    p = os.path.join(d, "clip.y4m")
    ns.y4m.write_y4m(p, frames)
    rgb, status = ns.ctl.load_preview_rgb(p)
    assert status == "ok" and rgb.shape == (h, w, 3) and (rgb[..., 0] == 40).all()
    rgb2, _ = ns.ctl.load_preview_rgb(p, frame_index=1)
    assert (rgb2[..., 0] == 80).all()
    none_rgb, msg = ns.ctl.load_preview_rgb(os.path.join(d, "missing.y4m"))
    assert none_rgb is None and "Preview unavailable" in msg
    return rgb.tolist(), rgb2.tolist(), msg.replace(d, "")


def test_setup(tmp_path):
    _both({"parse_duration": _parse_duration,
           "reference_summary": _reference_summary,
           "load_preview_rgb": _load_preview_rgb}, tmp_path)


# -- preview --------------------------------------------------------------------------------


def _to_rgb_variants(ns, d):
    to_rgb = ns.preview.to_rgb
    gray = np.full((4, 6), 100, np.uint8)
    bgr = np.zeros((4, 6, 3), np.uint8)
    bgr[..., 0] = 255
    hi = np.full((2, 2), 1000, np.uint16)
    out = [to_rgb(gray), to_rgb(bgr), to_rgb({"y": gray}), to_rgb(hi, bit_depth=10),
           to_rgb(hi), to_rgb(np.full((2, 2), 300.5, np.float32))]
    assert out[0][1] == "ok" and out[0][0].shape == (4, 6, 3) and (out[0][0][..., 0] == 100).all()
    assert (out[1][0][..., 2] == 255).all() and (out[1][0][..., 0] == 0).all()
    assert out[2][0].shape == (4, 6, 3)
    assert out[3][0].dtype == np.uint8 and (out[3][0] == 250).all() and (out[4][0] == 250).all()
    bad = [to_rgb(None), to_rgb(np.zeros((0,), np.uint8)), to_rgb("nonsense"),
           to_rgb(np.zeros((2, 2, 4), np.uint8))]
    assert bad[0] == (None, "No video feed received")
    assert [r for r, _ in bad] == [None] * 4
    assert "Empty" in bad[1][1] and "Invalid" in bad[2][1] and "Unsupported" in bad[3][1]
    return [(r.dtype.str, r.tolist(), s) for r, s in out], bad


def _preview_throttle_and_counters(ns, d):
    t = [0.0]
    pm = ns.ctl.PreviewModel(max_render_fps=10.0, clock=lambda: t[0])
    frame = np.full((4, 4), 50, np.uint8)
    got = [pm.submit(frame) is not None]
    got.append(pm.submit(frame) is not None)
    t[0] += 0.05
    got.append(pm.submit(frame) is not None)
    t[0] += 0.06
    got.append(pm.submit(frame) is not None)
    assert got == [True, False, False, True]
    assert (pm.frames_received, pm.frames_rendered, pm.counter_text) == (4, 2, "Frame: 4")
    return got, pm.counter_text


def _preview_invalid_frame_status(ns, d):
    pm = ns.ctl.PreviewModel(max_render_fps=0)
    assert pm.submit(None) is None and pm.last_status == "No video feed received"
    assert pm.submit(np.zeros((2, 2), np.uint8)) is not None and pm.last_status == "ok"
    return pm.frames_received, pm.frames_rendered, pm.last_status


def test_preview(tmp_path):
    _both({"to_rgb_variants": _to_rgb_variants,
           "throttle_and_counters": _preview_throttle_and_counters,
           "invalid_frame_status": _preview_invalid_frame_status}, tmp_path)


# -- formats, branding, exports ------------------------------------------------------------


def _format_detection_flow(ns, d):
    fc = ns.formats
    rows, source = fc.detect_formats(None)
    assert rows and source == "fallback" and any(r["id"] == "Hp29" for r in rows)
    disp = fc.format_display(rows[0])
    assert rows[0]["id"] in disp and "fps" in disp
    om = ns.om.OptionsManager(settings_file=os.path.join(d, "s.json"))
    hp29 = next(r for r in rows if r["id"] == "Hp29")
    updates = fc.apply_format(om, hp29)
    om.flush()
    assert updates["format_code"] == "Hp29"
    assert om.get_setting("capture", "format_code") == "Hp29"
    assert om.get_setting("capture", "resolution") == "1920x1080"
    assert float(om.get_setting("capture", "frame_rate")) == 29.97
    rows2, source2 = fc.detect_formats("DeckLink Mini Recorder")
    assert rows2
    return rows, disp, updates, rows2, source2


def _branding_logo_resolution(ns, d):
    branding = ns.branding
    assert os.path.isfile(branding.DEFAULT_LOGO)
    assert branding.resolve_logo_path(None) == branding.DEFAULT_LOGO
    om = ns.om.OptionsManager(settings_file=os.path.join(d, "s.json"))
    assert branding.resolve_logo_path(om) == branding.DEFAULT_LOGO
    custom = os.path.join(d, "corp.png")
    with open(custom, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
    om.update_setting("branding", "logo_path", custom)
    assert branding.resolve_logo_path(om) == custom
    om.update_setting("branding", "logo_path", os.path.join(d, "gone.png"))
    assert branding.resolve_logo_path(om) == branding.DEFAULT_LOGO
    with open(branding.DEFAULT_LOGO, "rb") as f:
        return f.read()


def _controllers_exports(ns, d):
    names = sorted(ns.ctl.__all__)
    assert all(hasattr(ns.ctl, n) for n in names)
    return names


def test_formats_branding_and_exports(tmp_path):
    _both({"format_detection_flow": _format_detection_flow,
           "branding_logo_resolution": _branding_logo_resolution,
           "controllers_exports": _controllers_exports}, tmp_path)

