"""Multi-device scoring of the port (``pqa2_tpu_torch.parallel`` and the
sharded ladder of ``pipeline/batch.py``), on the CPU.

Meshes here list the CPU several times (``["cpu"] * 4``), the port's
counterpart of the JAX package's virtual host mesh; ``["cpu", "cpu:0"]``
are two distinct devices and so two worker threads.

  (a) mesh shapes, frame ranges and errors, ``make_mesh()`` without a
      card, and the locked launch counts under many threads;
  (b) ``score_clip_sharded``, ``make_sharded_scorer`` (PSNR/SSIM) and
      ``sharded_extract`` against the port's single-device ``score_clip``
      in every bit: uneven N, a 1-frame range, an entry with no frame, the
      integer, ``integer_fast``, float and bootstrap (M, N) models, 8 and
      10 bits, two worker threads;
  (c) against the JAX package's ``make_sharded_scorer`` (2x2 mesh, 10 bits,
      PSNR/SSIM) and ``score_clip_sharded``/``make_shardmap_scorer`` (as
      its sharded ladder calls them: 8 bits, and a mixed 8/10-bit pair
      with a float model) on a 4-device CPU mesh;
  (d) ``run_batch_suite(mesh=)`` against the JAX package's sharded sweep on
      the same ladder: summary and row keys, per-clip JSON values;
  (e) ``multihost`` in a two-process gloo group, and its single-process
      no-op;
  (f) ``cli dryrun --platform cpu --devices 4`` in this process.

The JAX side runs in two child interpreters at once (tests/test_torch_fast.py:
jax_child), the 2-D scorer in one and the sweep in the other: in one
process the JAX package's pjit program after its shard_map one fails
("Mesh for all inputs should be equal"), and its shard_map program after
the pjit one hangs. Tolerances against JAX, as tests/test_torch_slice.py and
tests/test_torch_slice_float.py state them: integer VIF equal in every bit,
ADM atol 2e-6, motion rtol 1e-6, VMAF atol 1e-3; the float family VIF/ADM
atol 5e-5, motion rtol 1e-5, VMAF 5e-3; PSNR atol 1e-4, SSIM 1e-6. The JSON
logs round to 6 decimals, so JSON values get 1e-6 more.

Keep this file below eight tests: pytest-xdist's ``--dist loadfile`` queues
files by their number of tests (ROADMAP Q1.0).
"""

import concurrent.futures
import json
import os
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from pqa2_tpu_torch.io.y4m import write_y4m
from test_torch_fast import ROOT, _smooth, jax_child
from test_torch_slice import ADM_ATOL, MOTION_RTOL, PSNR_ATOL, SSIM_ATOL, VMAF_ATOL
from test_torch_slice_float import (
    FLOAT_ADM_ATOL,
    FLOAT_MOTION_RTOL,
    FLOAT_VIF_ATOL,
    FLOAT_VMAF_ATOL,
)

N, H, W = 10, 48, 64
JSON_STEP = 1e-6


def _pair(seed, n=N, depth=8):
    """(ref, dist) as the pipeline hands them over: uint8 codes at 8 bits,
    else f32 on the 8-bit scale."""
    r, d = _smooth(seed, n, H, W, depth)
    if depth == 8:
        return r.astype(np.uint8), d.astype(np.uint8)
    s = float(1 << (depth - 8))
    return (r / s).astype(np.float32), (d / s).astype(np.float32)


def _assert_bits(got, want, keys):
    for k in keys:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _single(ref, dist, **kw):
    from pqa2_tpu_torch.pipeline.scoring import score_clip

    s = score_clip(ref, dist, device="cpu", **kw)
    out = {"vmaf": s.vmaf, **s.features}
    if s.bootstrap is not None:
        out["vmaf_bootstrap"] = s.bootstrap
    return out


def test_mesh_shapes_ranges_and_errors():
    from pqa2_tpu_torch import _build
    from pqa2_tpu_torch.parallel import (
        frame_sharding,
        make_mesh,
        make_sharded_scorer,
        make_shardmap_scorer,
        replicated,
        shard_frames,
    )
    from pqa2_tpu_torch.parallel.mesh import DATA_AXIS, SPACE_AXIS

    mesh = make_mesh(devices=["cpu"] * 8)
    assert mesh.devices.size == 8 and mesh.shape == {DATA_AXIS: 8, SPACE_AXIS: 1}
    mesh2 = make_mesh(n_data=4, n_space=2, devices=["cpu"] * 8)
    assert mesh2.shape == {"data": 4, "space": 2} and mesh2.devices.shape == (4, 2)
    assert mesh2.distinct() == [torch.device("cpu")] and replicated(mesh2).mesh is mesh2
    with pytest.raises(ValueError, match="needs 32 devices"):
        make_mesh(n_data=16, n_space=2, devices=["cpu"] * 8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            make_mesh()
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            make_mesh(devices=["cuda:0"] * 2)

    def sizes(n, k):
        return [b - a for _, a, b in frame_sharding(make_mesh(devices=["cpu"] * k)).ranges(n)]

    assert sizes(72, 5) == [15, 15, 14, 14, 14] and sizes(10, 4) == [3, 3, 2, 2]
    assert sizes(5, 4) == [2, 1, 1, 1] and sizes(3, 4) == [1, 1, 1, 0]
    m4 = make_mesh(devices=["cpu"] * 4)
    ref8, _ = _pair(1)
    ref10, _ = _pair(1, depth=10)
    s8, s10 = shard_frames(ref8, m4), shard_frames(list(ref10), m4)
    assert [sh.frames.dtype for sh in s8.shards] == [torch.uint8] * 4  # bytes travel
    assert [sh.frames.dtype for sh in s10.shards] == [torch.float32] * 4
    assert [(sh.start, sh.stop) for sh in s8.shards] == [(0, 3), (3, 6), (6, 8), (8, 10)]
    np.testing.assert_array_equal(torch.cat([sh.frames for sh in s10.shards]).numpy(), ref10)
    assert len(shard_frames(ref8[:3], m4).shards) == 3
    with pytest.raises(ValueError, match="data-only mesh"):
        make_shardmap_scorer(make_mesh(2, 2, devices=["cpu"] * 4))
    step = make_sharded_scorer(m4)
    with pytest.raises(ValueError, match="another mesh"):
        step(shard_frames(ref8, make_mesh(devices=["cpu"] * 4)), ref8)
    with pytest.raises(ValueError, match="laid out differently"):
        step(ref8, ref8[:9])

    # The launch counts are added under a lock: no update is lost when many
    # threads count at once with a short switch interval.
    def probe():
        pass

    probe.launches = 0
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [_build.count(probe) for _ in range(2000)])
                   for _ in range(4 * (os.cpu_count() or 1))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert probe.launches == 2000 * len(threads)


def test_sharded_equals_single_device_in_every_bit():
    from pqa2_tpu_torch.parallel import (
        make_mesh,
        make_sharded_scorer,
        score_clip_sharded,
        sharded_extract,
    )
    from pqa2_tpu_torch.pipeline.features import extract_features_batched, model_feature_params
    from pqa2_tpu_torch.models.registry import get_model
    from pqa2_tpu_torch.pipeline.scoring import plane_metrics, upload

    m4 = make_mesh(devices=["cpu"] * 4)
    two = make_mesh(devices=["cpu", "cpu:0"])
    assert len(two.distinct()) == 2  # two worker threads
    ref, dist = _pair(2)
    cases = [
        ("vmaf_v0.6.1", None, 8, N, m4),            # ranges 3, 3, 2, 2
        ("vmaf_v0.6.1", None, 8, 5, m4),            # a 1-frame range: 2, 1, 1, 1
        ("vmaf_v0.6.1", None, 8, 3, m4),            # an entry with no frame
        ("vmaf_v0.6.1", "integer_fast", 8, N, m4),
        ("vmaf_float_v0.6.1", None, 8, N, make_mesh(devices=["cpu"] * 3)),
        ("vmaf_float_b_v0.6.3", None, 8, 7, m4),    # bootstrap (M, N)
        ("vmaf_v0.6.1", None, 10, N, two),
    ]
    for model, precision, depth, n, mesh in cases:
        r, d = (ref, dist) if depth == 8 else _pair(3, depth=10)
        r, d = r[:n], d[:n]
        want = _single(r, d, model=model, precision=precision, bit_depth=depth)
        got = score_clip_sharded(r, d, mesh, model=model, precision=precision,
                                 bit_depth=depth)
        assert got.pop("n_frames") == n
        assert set(got) == set(want), (model, set(got) ^ set(want))
        _assert_bits(got, want, want)
        if model == "vmaf_float_b_v0.6.3":
            assert got["vmaf_bootstrap"].shape == (get_model(model).n_models, n)
        got["vmaf"][0] = -1.0  # writable

    # The 2-D scorer: 2x2 entries, PSNR/SSIM by stream_score's rules.
    for depth in (8, 10):
        r, d = (ref, dist) if depth == 8 else _pair(4, depth=10)
        out = make_sharded_scorer(make_mesh(2, 2, devices=["cpu"] * 4), with_psnr_ssim=True,
                                  bit_depth=depth)(r, d)
        _assert_bits(out, _single(r, d, bit_depth=depth),
                     ("vmaf", "adm2", "motion", "motion2", "vif_scale0", "vif_scale3"))
        psnr, ssim = plane_metrics({"y": (upload(r, torch.device("cpu")).float(),
                                          upload(d, torch.device("cpu")).float())},
                                   depth, True, True)
        np.testing.assert_array_equal(out["psnr_y"], psnr["psnr_y"])
        np.testing.assert_array_equal(out["ssim_y"], ssim["ssim_y"])

    params = model_feature_params(get_model("vmaf_float_v0.6.1"), device="cpu")
    feats = sharded_extract(ref, dist, m4, **params)
    whole = extract_features_batched(torch.from_numpy(ref), torch.from_numpy(dist), **params)
    _assert_bits(feats, {k: v.numpy() for k, v in whole.items()}, whole)


_JAX_2D = """
from pqa2_tpu.parallel import make_mesh, make_sharded_scorer, shard_frames
m22 = make_mesh(n_data=2, n_space=2, devices=jax.devices()[:4])
step = make_sharded_scorer(m22, with_psnr_ssim=True, bit_depth=10)
res = step(shard_frames(z["r10"], m22), shard_frames(z["d10"], m22))
with open(sys.argv[2], "wb") as fh:
    pickle.dump({k: np.asarray(v) for k, v in res.items()}, fh)
"""

# The sharded ladder; every score_clip_sharded result is kept unrounded.
_JAX_SWEEP = """
import json
from pqa2_tpu.parallel import make_mesh
import pqa2_tpu.parallel.scoring as ps
from pqa2_tpu.pipeline.batch import run_batch_suite
calls = []
orig = ps.score_clip_sharded
def keep(*a, **k):
    r = orig(*a, **k)
    calls.append({kk: np.array(v) for kk, v in r.items()})
    return r
ps.score_clip_sharded = keep
summary = run_batch_suite(json.loads(str(z["spec"])), str(z["out_dir"]),
                          mesh=make_mesh(n_data=4, n_space=1, devices=jax.devices()[:4]))
with open(sys.argv[2], "wb") as fh:
    pickle.dump({"calls": calls, "summary": summary}, fh)
"""


@pytest.fixture(scope="module")
def ladder(tmp_path_factory):
    """A three-rung ladder (8-bit rung; the reference against itself; a
    10-bit reference against an 8-bit rung with a float model), the 2x2
    scorer's 10-bit inputs, and the JAX package's outputs on them."""
    d = tmp_path_factory.mktemp("parallel")
    ref, dist = _pair(5)
    r10 = _smooth(6, N, H, W, 10)[0].astype(np.uint16)
    c8 = np.full((H // 2, W // 2), 128, np.uint8)
    c10 = np.full((H // 2, W // 2), 512, np.uint16)
    paths = {k: str(d / f"{k}.y4m") for k in ("ref", "dist", "ref10")}
    write_y4m(paths["ref"], [{"y": y, "u": c8, "v": c8} for y in ref])
    write_y4m(paths["dist"], [{"y": y, "u": c8, "v": c8} for y in dist])
    write_y4m(paths["ref10"], [{"y": y, "u": c10, "v": c10} for y in r10],
              colorspace="C420p10")
    spec = {"entries": [
        {"reference": paths["ref"], "distorted": paths["dist"], "name": "rung_a"},
        {"reference": paths["ref"], "distorted": paths["ref"], "name": "rung_ref"},
        {"reference": paths["ref10"], "distorted": paths["dist"], "name": "rung_mixed",
         "model": "vmaf_float_v0.6.1"}]}
    r2, d2 = _pair(7, n=8, depth=10)
    # The two children run at once: each compiles on one core for most of
    # its time.
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        two_d = ex.submit(jax_child, _JAX_2D, {"r10": r2, "d10": d2},
                          tmp_path_factory.mktemp("jax_2d"))
        sweep = ex.submit(jax_child, _JAX_SWEEP, {"spec": json.dumps(spec),
                                                  "out_dir": str(d / "jax_suite")},
                          tmp_path_factory.mktemp("jax_sweep"))
        jax_out = {"2d": two_d.result(), **sweep.result()}
    return spec, {"r10": r2, "d10": d2}, d, jax_out


def test_sharded_scorers_match_jax(ladder):
    from pqa2_tpu_torch.io.video import VideoReader
    from pqa2_tpu_torch.parallel import make_mesh, make_sharded_scorer, score_clip_sharded

    spec, inputs, _, jax_out = ladder
    got = make_sharded_scorer(make_mesh(2, 2, devices=["cpu"] * 4), with_psnr_ssim=True,
                              bit_depth=10)(inputs["r10"], inputs["d10"])
    want = jax_out["2d"]
    assert set(got) == set(want)
    _check_features(got, want, "integer")
    np.testing.assert_allclose(got["psnr_y"], want["psnr_y"], rtol=0, atol=PSNR_ATOL)
    np.testing.assert_allclose(got["ssim_y"], want["ssim_y"], rtol=0, atol=SSIM_ATOL)

    def luma(path):
        with VideoReader(path) as r:
            depth = r.info.bit_depth
            return np.stack([f["y"] for f in r]), depth

    m4 = make_mesh(devices=["cpu"] * 4)
    calls = jax_out["calls"]
    assert len(calls) == 3
    for entry, want in zip(spec["entries"], calls):
        (r, rd), (d, dd) = luma(entry["reference"]), luma(entry["distorted"])
        depth = max(rd, dd)
        if depth > 8:
            r = (r / float(1 << (rd - 8))).astype(np.float32)
            d = (d / float(1 << (dd - 8))).astype(np.float32)
        model = entry.get("model", "vmaf_v0.6.1")
        got = score_clip_sharded(r, d, m4, model=model, bit_depth=depth)
        assert set(got) == set(want) and got["n_frames"] == want["n_frames"] == N
        _check_features(got, want, "float" if "float" in model else "integer")


def _check_features(got, want, family):
    if family == "integer":
        vif, adm, motion, vmaf = 0.0, ADM_ATOL, MOTION_RTOL, VMAF_ATOL
    else:
        vif, adm, motion, vmaf = FLOAT_VIF_ATOL, FLOAT_ADM_ATOL, FLOAT_MOTION_RTOL, FLOAT_VMAF_ATOL
    for s in range(4):
        np.testing.assert_allclose(got[f"vif_scale{s}"], want[f"vif_scale{s}"], rtol=0, atol=vif)
    np.testing.assert_allclose(got["adm2"], want["adm2"], rtol=0, atol=adm)
    for k in ("motion", "motion2"):
        np.testing.assert_allclose(got[k], want[k], rtol=motion, atol=0)
    np.testing.assert_allclose(got["vmaf"], want["vmaf"], rtol=0, atol=vmaf)


def test_sharded_batch_suite_matches_jax(ladder):
    from pqa2_tpu_torch.parallel import make_mesh
    from pqa2_tpu_torch.pipeline.batch import run_batch_suite

    spec, _, d, jax_out = ladder
    logs = []
    summary = run_batch_suite(spec, str(d / "port_suite"), mesh=make_mesh(devices=["cpu"] * 4),
                              log=logs.append)
    want = jax_out["summary"]
    assert set(summary) == set(want) and summary["mesh_devices"] == want["mesh_devices"] == 4
    with open(d / "port_suite" / "batch_summary.json") as f:
        assert json.load(f)["n_clips"] == 3
    assert summary["total_frames"] == want["total_frames"] == 3 * N
    assert summary["aggregate_fps_per_device"] > 0
    # The shared reference is decoded once (LRU cache).
    assert sum(m.startswith("  decode: ") for m in logs) == 3
    assert sum(m.startswith("  luma cache hit: ") for m in logs) == 3
    for row, jrow in zip(summary["clips"], want["clips"]):
        assert set(row) == set(jrow) and "error" not in row, row
        assert row["psnr"] is row["ssim"] is None and row["frames"] == N
        np.testing.assert_allclose(row["vmaf"], jrow["vmaf"], rtol=0, atol=FLOAT_VMAF_ATOL)
        with open(row["json_path"]) as f:
            got = json.load(f)
        with open(jrow["json_path"]) as f:
            exp = json.load(f)
        assert os.path.basename(row["json_path"]) == os.path.basename(jrow["json_path"])
        assert set(got) == set(exp) and len(got["frames"]) == len(exp["frames"]) == N
        integer = row["name"] != "rung_mixed"
        for g, e in zip(got["frames"], exp["frames"]):
            assert set(g["metrics"]) == set(e["metrics"])
            for k, v in g["metrics"].items():
                if k == "vmaf":
                    tol = VMAF_ATOL if integer else FLOAT_VMAF_ATOL
                elif "vif" in k:
                    tol = 0.0 if integer else FLOAT_VIF_ATOL
                elif "adm" in k:
                    tol = ADM_ATOL if integer else FLOAT_ADM_ATOL
                else:  # motion: its relative budget at the clip's values
                    tol = (MOTION_RTOL if integer else FLOAT_MOTION_RTOL) * abs(e["metrics"][k])
                assert abs(v - e["metrics"][k]) <= tol + JSON_STEP, (row["name"], k, v,
                                                                      e["metrics"][k])
    # A failing entry gets an error row and the sweep goes on.
    bad = {"pairs": [[spec["entries"][0]["reference"], str(d / "missing.y4m")]]}
    out = run_batch_suite(bad, str(d / "bad_suite"), mesh=make_mesh(devices=["cpu"] * 2))
    assert "error" in out["clips"][0] and out["total_frames"] == 0


_RANK = """
import json, sys
from pqa2_tpu_torch.parallel import multihost
rank = int(sys.argv[2])
assert multihost.initialize(sys.argv[1], 2, rank, device="cpu")
mine = multihost.shard_clip_list([f"clip{i}" for i in range(5)])
got = multihost.gather_summaries([{"clip": c, "rank": rank} for c in mine])
import torch.distributed as dist
dist.destroy_process_group()
print(json.dumps({"mine": mine, "all": got}))
"""


def test_multihost_two_process_gloo(monkeypatch):
    from pqa2_tpu_torch.parallel import multihost

    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert multihost.initialize() is False  # nothing configured: no-op
    clips = [f"clip{i}" for i in range(7)]
    assert multihost.shard_clip_list(clips) == clips
    assert multihost.shard_clip_list(clips, process_id=1, num_processes=3) == ["clip1", "clip4"]
    assert multihost.gather_summaries([{"clip": "a"}]) == [{"clip": "a"}]

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, f"127.0.0.1:{port}", str(r)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in (0, 1)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err[-3000:]
        outs.append(json.loads(out.strip().splitlines()[-1]))
    assert outs[0]["mine"] == ["clip0", "clip2", "clip4"]
    assert outs[1]["mine"] == ["clip1", "clip3"]
    want = [{"clip": c, "rank": 0} for c in ("clip0", "clip2", "clip4")] + [
        {"clip": c, "rank": 1} for c in ("clip1", "clip3")]
    assert outs[0]["all"] == outs[1]["all"] == want


def test_dryrun_subcommand_on_cpu(capsys):
    from pqa2_tpu_torch import cli

    assert cli.main(["dryrun", "--platform", "cpu", "--devices", "4"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("dryrun_multichip ok (4 entries on the CPU): mesh=(2x2)")
    assert "data-only mesh=(4x1)" in line and "in every bit" in line
