"""The port's batch ladder suite (``pipeline/batch.py``), scoring service
(``app/service.py``) and their subcommands, on the CPU, against the JAX
package's.

  (a) ``run_batch_suite(device="cpu")`` on a two-rung ladder against the
      JAX package's ``batch`` subcommand (its ``run_batch_suite``): the
      same summary and row keys, the same per-clip file names (timestamps
      aside), the rows' and the JSON logs' per-frame scores within the
      tolerances below;
  (b) ``ScoringService(device="cpu")``: jobs, a failed job (the worker
      survives), cancelling a queued job, stop then start, the retention
      cap and the rule that a null ``psnr`` means enabled; the HTTP surface
      on port 0 (every route, 400, 404 and 409) exchanged by the same
      client code (``_HTTP``) with the port's service and the JAX one:
      status codes, JSON keys and error messages equal;
  (c) the job dict's keys and ``validate_spec``'s verdicts on a fixed list
      of good and bad specs equal the JAX service's;
  (d) the ``batch`` and ``serve`` subcommands with ``-v`` and
      ``--models-dir``: ``batch`` prints the JAX CLI's keys, and ``serve``
      (its own process, stopped by SIGINT) answers the ``_HTTP`` exchange
      as the JAX service does;
  (e) without a card, at the default device: the service's jobs fail with
      the card's error and its worker goes on, ``serve_forever``, ``serve``,
      ``run_batch_suite`` and ``batch`` raise before binding a socket or
      writing a file; ``validate_application_state`` reports
      ``cuda_devices`` where the JAX package reports ``jax_devices``.

The JAX side runs in one child interpreter (tests/test_torch_fast.py:
jax_child). Tolerances against JAX, as tests/test_torch_workflow.py states
them: VMAF atol 1e-3, PSNR atol 1e-4, SSIM atol 1e-6.

Keep this file below eight tests: pytest-xdist's ``--dist loadfile`` queues
files by their number of tests (ROADMAP Q1.0).
"""

import json
import os
import re
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from pqa2_tpu_torch.io.y4m import write_y4m
from test_torch_fast import ROOT, jax_child
from test_torch_slice import PSNR_ATOL, SSIM_ATOL, VMAF_ATOL

N, H, W = 4, 48, 64

# Good and bad job specs; validate_spec's verdict on each must be JAX's.
SPECS = [
    {}, [], "x", {"reference": "a"}, {"distorted": "b"}, {"reference": "", "distorted": "b"},
    {"reference": 1, "distorted": "b"}, {"reference": "a", "distorted": "b"},
    {"reference": "a", "distorted": "b", "precision": "bogus"},
    {"reference": "a", "distorted": "b", "precision": "integer_fast", "pool": "min"},
    {"reference": "a", "distorted": "b", "pool": "median"},
    {"reference": "a", "distorted": "b", "nope": 1, "other": 2},
    {"reference": "a", "distorted": "b", "subsample": "2"},
    {"reference": "a", "distorted": "b", "subsample": True},
    {"reference": "a", "distorted": "b", "duration": True},
    {"reference": "a", "distorted": "b", "duration": 1.5, "subsample": 2},
    {"reference": "a", "distorted": "b", "psnr": None, "model": None, "ssim": False},
    {"reference": "a", "distorted": "b", "psnr": 1},
    {"reference": "a", "distorted": "b", "test_name": 3},
]

# The HTTP client both services are held to: exchange(port, rp, dp) -> a
# list of (request, status, JSON keys, a value that must agree).
_HTTP = r'''
import http.client, json, time

def exchange(port, rp, dp):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    out = []

    def req(method, path, body=None, raw=None):
        data = raw if raw is not None else (json.dumps(body) if body is not None else None)
        conn.request(method, path, body=data)
        r = conn.getresponse()
        return r.status, json.loads(r.read() or b"{}")

    def note(label, code, obj, value=None):
        out.append((label, code, sorted(obj) if isinstance(obj, dict) else None, value))

    code, h = req("GET", "/healthz")
    note("healthz", code, h, h.get("status"))
    code, m = req("GET", "/models")
    note("models", code, m, m.get("models"))
    code, s = req("POST", "/score", {"reference": rp, "distorted": dp, "ssim": False})
    note("score", code, s)
    job_id = s["job_id"]
    deadline = time.time() + 300
    while True:
        code, j = req("GET", "/jobs/" + job_id)
        if j["status"] not in ("queued", "running") or time.time() > deadline:
            break
        time.sleep(0.05)
    note("job", code, j, j["status"])
    note("job result", code, j.get("result", {}), j.get("error"))
    note("job pooled_metrics", code, j.get("result", {}).get("pooled_metrics", {}))
    code, lst = req("GET", "/jobs")
    note("jobs", code, lst, [x["job_id"] == job_id for x in lst["jobs"]][:1])
    code, lst = req("GET", "/jobs?limit=0")
    note("jobs limit 0", code, lst, lst.get("jobs"))
    code, e = req("GET", "/jobs?limit=x")
    note("jobs limit x", code, e, e.get("error"))
    code, e = req("POST", "/score", {"reference": rp})
    note("score no distorted", code, e, e.get("error"))
    code, e = req("POST", "/score", raw="{not json")
    note("score bad json", code, e, e.get("error"))
    code, e = req("POST", "/score", {"reference": rp, "distorted": dp, "pool": "median"})
    note("score bad pool", code, e, e.get("error"))
    code, e = req("GET", "/jobs/job-404")
    note("job 404", code, e, e.get("error"))
    code, e = req("POST", "/jobs/job-404/cancel", {"ignored": 1})
    note("cancel 404", code, e, e.get("error"))
    code, e = req("POST", "/jobs/" + job_id + "/cancel", {"ignored": 1})
    note("cancel finished", code, e, e.get("error"))
    code, e = req("GET", "/bogus")
    note("get bogus", code, e, e.get("error"))
    code, e = req("POST", "/bogus")
    note("post bogus", code, e, e.get("error"))
    code, h = req("GET", "/healthz/?probe=1")
    note("healthz query", code, h, [h.get(k) for k in ("jobs_done", "jobs_failed",
                                                       "jobs_queued", "jobs_running")])
    conn.close()
    return out
'''

_JAX = _HTTP + r'''
import contextlib, io, os, threading
from pqa2_tpu import cli
from pqa2_tpu.app.service import ScoringService
from pqa2_tpu.models.registry import set_user_models_dir

rp, dp, dp2, out = (str(z[k]) for k in ("ref", "dist", "dist2", "out"))
set_user_models_dir(str(z["models_dir"]))
ladder = os.path.join(out, "ladder.json")
with open(ladder, "w") as f:
    json.dump({"pairs": [[rp, dp], [rp, dp2]]}, f)
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    assert cli.main(["batch", ladder, "--out", os.path.join(out, "suite")]) == 0
summary = json.loads(buf.getvalue())
files, frames = {}, {}
for row in summary["clips"]:
    files[row["name"]] = sorted(os.listdir(os.path.join(out, "suite", row["name"])))
    with open(row["json_path"]) as f:
        frames[row["name"]] = json.load(f)["frames"]

svc = ScoringService(out_dir=os.path.join(out, "svc"))
verdicts = [svc.validate_spec(s) for s in json.loads(str(z["specs"]))]
svc.start()
job = svc.submit({"reference": rp, "distorted": dp})
while job.status in ("queued", "running"):
    time.sleep(0.05)
job_dict = job.to_dict()
svc.stop()
svc = ScoringService(out_dir=os.path.join(out, "http"))
svc.start()
httpd = svc.make_server(port=0)
threading.Thread(target=httpd.serve_forever, daemon=True).start()
try:
    http = exchange(httpd.server_address[1], rp, dp)
finally:
    httpd.shutdown()
    httpd.server_close()
    svc.stop()
with open(sys.argv[2], "wb") as f:
    pickle.dump({"summary": summary, "files": files, "frames": frames, "verdicts": verdicts,
                 "job": job_dict, "http": http}, f)
'''


def _exchange(port, rp, dp):
    scope = {}
    exec(_HTTP, scope)
    return scope["exchange"](port, rp, dp)


def _clip(ys):
    return [{"y": y, "u": np.full((H // 2, W // 2), 128, np.uint8),
             "v": np.full((H // 2, W // 2), 120, np.uint8)} for y in ys]


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """Smooth reference content and two distortions of it (noise of +-4 and
    +-12), so the scores sit below their clip at 100."""
    d = tmp_path_factory.mktemp("torch_service")
    rng = np.random.default_rng(30)
    base = rng.uniform(16, 235, size=(N, H, W))
    for _ in range(2):
        base = (base + np.roll(base, 1, -1) + np.roll(base, -1, -1)
                + np.roll(base, 1, -2) + np.roll(base, -1, -2)) / 5.0
    ref = np.round(base).astype(np.uint8)
    paths = {"ref": str(d / "ref.y4m")}
    write_y4m(paths["ref"], _clip(ref))
    for name, amp in (("dist", 4), ("dist2", 12)):
        dist = np.clip(ref.astype(np.int16) + rng.integers(-amp, amp + 1, ref.shape), 0, 255)
        paths[name] = str(d / f"{name}.y4m")
        write_y4m(paths[name], _clip(dist.astype(np.uint8)))
    models = d / "models"
    models.mkdir()
    (models / "user_model.json").write_text("{}")
    paths["models_dir"] = str(models)
    return d, paths


@pytest.fixture(scope="module")
def jax_side(clips, tmp_path_factory):
    d, paths = clips
    inputs = {k: np.array(v) for k, v in paths.items()}
    inputs["out"] = np.array(str(d / "jax"))
    inputs["specs"] = np.array(json.dumps(SPECS))
    os.makedirs(d / "jax")
    return jax_child(_JAX, inputs, tmp_path_factory.mktemp("jax"))


def _wait(job, timeout=300.0):
    t0 = time.time()
    while job.status in ("queued", "running"):
        assert time.time() - t0 < timeout, f"job stuck in {job.status}"
        time.sleep(0.05)
    return job


def _strip_ts(names):
    return sorted(re.sub(r"_\d{8}_\d{6}_", "_TS_", n) for n in names)


def _check_summary(got, jax_side, out_dir):
    """Summary and row keys, file names and scores against JAX's summary."""
    want = jax_side["summary"]
    assert set(got) == set(want) and got["model"] == want["model"]
    assert got["n_clips"] == want["n_clips"] == 2
    assert got["total_frames"] == want["total_frames"] == 2 * N
    for g, w in zip(got["clips"], want["clips"]):
        assert set(g) == set(w) and g["name"] == w["name"] and g["frames"] == w["frames"]
        assert _strip_ts(os.listdir(os.path.join(out_dir, g["name"]))) == _strip_ts(
            jax_side["files"][w["name"]])
        assert os.path.basename(g["html_report"]) == f"{g['name']}_report.html"
        assert os.path.exists(os.path.join(out_dir, g["name"], f"{g['name']}_frames.csv"))
        np.testing.assert_allclose(g["vmaf"], w["vmaf"], rtol=0, atol=VMAF_ATOL)
        np.testing.assert_allclose(g["psnr"], w["psnr"], rtol=0, atol=PSNR_ATOL)
        np.testing.assert_allclose(g["ssim"], w["ssim"], rtol=0, atol=SSIM_ATOL)
        assert 20 < g["vmaf"] < 99.9
    with open(os.path.join(out_dir, "batch_summary.json")) as f:
        assert json.load(f) == json.loads(json.dumps(got, default=str))


def test_batch_suite_matches_jax(clips, jax_side, tmp_path):
    from pqa2_tpu_torch.pipeline.batch import run_batch_suite

    d, p = clips
    seen = []
    out = str(tmp_path / "suite")
    got = run_batch_suite({"pairs": [[p["ref"], p["dist"]], [p["ref"], p["dist2"]]]}, out,
                          log=seen.append, device="cpu")
    _check_summary(got, jax_side, out)
    assert seen == ["[1/2] scoring dist", "[2/2] scoring dist2"]
    for row in got["clips"]:
        with open(row["json_path"]) as f:
            frames = json.load(f)["frames"]
        jframes = jax_side["frames"][row["name"]]
        assert [f["frameNum"] for f in frames] == [f["frameNum"] for f in jframes]
        for key, atol in (("vmaf", VMAF_ATOL), ("psnr_y", PSNR_ATOL), ("float_ssim", SSIM_ATOL)):
            np.testing.assert_allclose([f["metrics"][key] for f in frames],
                                       [f["metrics"][key] for f in jframes], rtol=0,
                                       atol=atol + 1e-6, err_msg=key)  # + the JSON's rounding
    with pytest.raises(ValueError, match="no pairs/entries"):
        run_batch_suite({}, str(tmp_path / "empty"), device="cpu")
    named = run_batch_suite({"entries": [{"reference": p["ref"], "distorted": p["dist"],
                                          "name": "rung", "model": "vmaf_float_v0.6.1"},
                                         {"reference": p["ref"], "distorted": "/nope.y4m"}]},
                            str(tmp_path / "named"), device="cpu")
    assert named["clips"][0]["name"] == "rung" and named["total_frames"] == N
    assert named["clips"][1] == {"name": "nope", "error": "analysis failed"}


def test_service_jobs_on_cpu(clips, tmp_path, monkeypatch):
    from pqa2_tpu_torch.app import service as service_mod
    from pqa2_tpu_torch.app.service import ScoringService

    _, p = clips
    svc = ScoringService(out_dir=str(tmp_path / "results"), device="cpu")
    try:
        # Queued before the worker starts: cancelled, and skipped by it.
        queued = svc.submit({"reference": p["ref"], "distorted": p["dist"]})
        assert svc.cancel(queued.id) and queued.status == "cancelled"
        assert not svc.cancel("job-999")
        svc.start()
        bad = _wait(svc.submit({"reference": "/nonexistent/a.y4m",
                                "distorted": "/nonexistent/b.y4m"}))
        assert bad.status == "error" and "not found" in bad.error
        job = _wait(svc.submit({"reference": p["ref"], "distorted": p["dist"],
                                "precision": "float", "psnr": None, "ssim": False}))
        assert job.status == "done", job.error
        assert queued.status == "cancelled" and svc._analyzer.device == torch.device("cpu")
        res = job.result
        assert res["psnr_score"] is not None and res["ssim_score"] is None  # null = default
        assert res["frame_count"] == N and os.path.exists(res["json_path"])
        assert res["pooled_metrics"]["vmaf"]["mean"] == pytest.approx(res["vmaf_score"],
                                                                       abs=1e-4)

        def no_tensors(o):
            assert not isinstance(o, torch.Tensor)
            for v in (o.values() if isinstance(o, dict) else
                      o if isinstance(o, (list, tuple)) else ()):
                no_tensors(v)

        no_tensors(job.to_dict())
        json.dumps(job.to_dict(), allow_nan=False)
        assert svc.stats()["jobs_done"] == 1 and svc.stats()["jobs_failed"] == 1
        # stop() then start(): a live worker again, reusing the analyzer.
        analyzer = svc._analyzer
        svc.stop()
        svc.start()
        again = _wait(svc.submit({"reference": p["ref"], "distorted": p["dist"],
                                  "precision": "float", "psnr": None, "ssim": False}))
        assert again.status == "done" and svc._analyzer is analyzer
        assert again.result["vmaf_score"] == res["vmaf_score"]
    finally:
        svc.stop()
    # The retention cap: the oldest finished jobs go, queued ones stay.
    monkeypatch.setattr(service_mod, "_MAX_FINISHED_JOBS", 3)
    idle = ScoringService(device="cpu")
    jobs = [idle.submit({"reference": "r", "distorted": "d"}) for _ in range(6)]
    for j in jobs[:5]:
        idle.cancel(j.id)
    idle.submit({"reference": "r", "distorted": "d"})
    listed = {j["job_id"]: j["status"] for j in idle.jobs()}
    assert sum(s == "cancelled" for s in listed.values()) == 3
    assert jobs[0].id not in listed and jobs[1].id not in listed and jobs[5].id in listed
    assert len(idle.jobs(limit=1)) == 1
    assert service_mod._json_safe({"a": np.float32("nan"), "b": np.array([1.0, -np.inf]),
                                   "c": np.int64(3)}) == {"a": None, "b": [1.0, -1e9], "c": 3}


def test_http_surface_matches_jax(clips, jax_side, tmp_path):
    from pqa2_tpu_torch.app.service import ScoringService
    from pqa2_tpu_torch.models import registry

    _, p = clips
    svc = ScoringService(out_dir=str(tmp_path / "results"), device="cpu")
    registry.set_user_models_dir(p["models_dir"])
    svc.start()
    httpd = svc.make_server(port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        got = _exchange(httpd.server_address[1], p["ref"], p["dist"])
    finally:
        httpd.shutdown()
        httpd.server_close()
        svc.stop()
        registry.set_user_models_dir(None)
    assert got == jax_side["http"]
    codes = {label: code for label, code, _, _ in got}
    assert codes["job"] == 200 and codes["score"] == 202 and codes["job 404"] == 404
    assert codes["score no distorted"] == 400 and codes["cancel finished"] == 409
    assert dict((label, v) for label, _, _, v in got)["job"] == "done"
    assert "user_model" in got[1][3]


def test_job_dict_and_verdicts_match_jax(clips, jax_side, tmp_path):
    from pqa2_tpu_torch.app.service import ScoringService

    _, p = clips
    svc = ScoringService(out_dir=str(tmp_path / "results"), device="cpu")
    assert [svc.validate_spec(s) for s in SPECS] == jax_side["verdicts"]
    assert sum(v is None for v in jax_side["verdicts"]) == 4
    svc.start()
    try:
        job = _wait(svc.submit({"reference": p["ref"], "distorted": p["dist"]}))
    finally:
        svc.stop()
    got, want = job.to_dict(), jax_side["job"]
    assert got["status"] == want["status"] == "done"
    assert set(got) == set(want) and set(got["result"]) == set(want["result"])
    assert set(got["result"]["pooled_metrics"]) == set(want["result"]["pooled_metrics"])
    assert got["spec"] == want["spec"]
    np.testing.assert_allclose(got["result"]["vmaf_score"], want["result"]["vmaf_score"],
                               rtol=0, atol=VMAF_ATOL)


def test_batch_and_serve_subcommands_match_jax(clips, jax_side, tmp_path, capsys):
    import logging

    from pqa2_tpu_torch import cli
    from pqa2_tpu_torch.models import registry

    _, p = clips
    ladder = str(tmp_path / "ladder.json")
    with open(ladder, "w") as f:
        json.dump({"pairs": [[p["ref"], p["dist"]], [p["ref"], p["dist2"]]]}, f)
    root = logging.getLogger()
    level, handlers = root.level, list(root.handlers)
    try:
        out = str(tmp_path / "suite")
        assert cli.main(["-v", "--models-dir", p["models_dir"], "batch", ladder,
                         "--out", out, "--device", "cpu"]) == 0
        assert registry.get_user_models_dir() == p["models_dir"]
    finally:
        registry.set_user_models_dir(None)
        root.setLevel(level)
        root.handlers[:] = handlers
    got = json.loads(capsys.readouterr().out)
    _check_summary(got, jax_side, out)

    env = dict(os.environ, PYTHONPATH=str(ROOT))
    err = open(tmp_path / "serve.err", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "pqa2_tpu_torch", "-v", "--models-dir", p["models_dir"],
         "serve", "--port", "0", "--device", "cpu", "--out", str(tmp_path / "served")],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=err, text=True)
    try:
        line = proc.stdout.readline()
        m = re.match(r"\[serve\] listening on http://127\.0\.0\.1:(\d+)$", line.strip())
        assert m, (line, (tmp_path / "serve.err").read_text()[-3000:])
        assert _exchange(int(m.group(1)), p["ref"], p["dist"]) == jax_side["http"]
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
        err.close()
    assert os.listdir(tmp_path / "served")


def test_default_device_refuses_without_a_card(clips, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    from pqa2_tpu_torch import cli
    from pqa2_tpu_torch.app import service as service_mod
    from pqa2_tpu_torch.app.utils import validate_application_state
    from pqa2_tpu_torch.pipeline.batch import run_batch_suite

    _, p = clips
    bound = []
    monkeypatch.setattr(service_mod, "ThreadingHTTPServer",
                        lambda *a, **k: bound.append(a) or pytest.fail("bound a socket"))
    svc = service_mod.ScoringService(out_dir=str(tmp_path / "svc"))
    svc.start()
    try:
        jobs = [_wait(svc.submit({"reference": p["ref"], "distorted": p["dist"]}))
                for _ in range(2)]
    finally:
        svc.stop()
    for job in jobs:  # each fails with the card's error; the worker goes on
        assert job.status == "error" and "torch.cuda.is_available() is False" in job.error
    assert svc.stats()["jobs_failed"] == 2 and not os.path.exists(tmp_path / "svc")

    ladder = str(tmp_path / "ladder.json")
    with open(ladder, "w") as f:
        json.dump({"pairs": [[p["ref"], p["dist"]]]}, f)
    out = tmp_path / "out"
    for call in (lambda: service_mod.serve_forever(port=0, out_dir=str(out)),
                 lambda: cli.main(["serve", "--port", "0", "--out", str(out)]),
                 lambda: cli.main(["serve", "--port", "0", "--warmup"]),
                 lambda: run_batch_suite({"pairs": [[p["ref"], p["dist"]]]}, str(out)),
                 lambda: cli.main(["batch", ladder, "--out", str(out)])):
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            call()
    assert not bound and not out.exists()

    from pqa2_tpu.app.utils import validate_application_state as jax_state

    got, want = validate_application_state(), jax_state()
    assert set(got) - {"cuda_devices"} == set(want) - {"jax_devices"}
    assert got["cuda_devices"] is False and got["all_ok"] is False
