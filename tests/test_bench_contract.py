"""bench.py contract: a run on the GPU prints one JSON line that names its
device; a run without a GPU, or a failed one, exits nonzero and says
"not measured" — it never prints a number from another run or device."""
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _json_lines(text):
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


def test_bench_json_contract():
    """The record bench.py prints for a measured run has the keys readers
    rely on, and its rates follow from the counts and times."""
    import bench
    args = bench._parse_args(["--scene", "test", "--width", "32",
                              "--height", "16", "--spp", "1", "--depth", "2"])
    rec = bench.bench_record(
        args, accel="tensor", prims=3, nominal=1024, executed=900,
        shadow=0, dts=[0.5, 0.5], compile_s=3.0, bvh_build_s=None,
        peak_bytes=123, device={"platform": "gpu", "kind": "H100",
                                "count": 1}, gpu="H100, 700.00 W")
    assert set(rec) >= {"metric", "value", "unit", "accel", "prims",
                        "nominal_queries", "executed_queries",
                        "executed_mrays_per_s", "compile_s", "device",
                        "gpu"}
    assert rec["metric"] == "test_forward_throughput"
    assert rec["unit"] == "Mrays/s"
    assert abs(rec["value"] - 1024 / 0.5 / 1e6) < 1e-12
    assert 0 < rec["executed_queries"] <= rec["nominal_queries"]
    json.dumps(rec)  # serializable as one line


def test_bench_stale_fallback():
    """No GPU: nonzero exit and one JSON line with a null value that says
    "not measured" (the former stale re-emit path is gone)."""
    out = subprocess.run(
        [sys.executable, "bench.py", "--scene", "test", "--width", "32",
         "--height", "16", "--spp", "1", "--depth", "2", "--iters", "1"],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode != 0
    lines = _json_lines(out.stdout)
    assert len(lines) == 1, (out.stdout, out.stderr[-500:])
    assert lines[0]["value"] is None
    assert "not measured" in lines[0]["error"]


def test_bench_internal_deadline(monkeypatch, capsys):
    """A failure inside the measured run is reported, not swallowed: exit
    1 and "not measured" with the reason."""
    import bench

    def boom(args):
        raise RuntimeError("compile failed")
    monkeypatch.setattr(bench, "run", boom)
    assert bench.main(["--scene", "bunny"]) == 1
    (rec,) = _json_lines(capsys.readouterr().out)
    assert rec["value"] is None
    assert rec["error"].startswith("not measured")
    assert "compile failed" in rec["error"]


def test_bench_sigterm_fallback():
    """The measurement paths refuse the CPU in-process too
    (runtime.require_gpu), so no caller can time the CPU as the device."""
    import pytest

    from pathtracer_tpu import runtime
    with pytest.raises(RuntimeError, match="not measured"):
        runtime.require_gpu("bench")
