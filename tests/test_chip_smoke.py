"""chip_smoke.py's contract, checked where there is no GPU: it refuses
the CPU, its last line carries exactly the contract keys, and --cards 4
selects only the sharded phases."""
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def test_refuses_cpu_backend():
    out = subprocess.run([sys.executable, "chip_smoke.py"],
                         capture_output=True, text=True, timeout=300,
                         cwd=REPO, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr


def test_last_line_has_exactly_the_contract_keys():
    line = chip_smoke.last_line({"platform": "gpu", "kind": "NVIDIA H100",
                                 "count": 1, "extra": "dropped"})
    rec = json.loads(line)
    assert rec == {"ok": True, "device": {"platform": "gpu",
                                          "kind": "NVIDIA H100",
                                          "count": 1}}
    assert "\n" not in line


def test_cards_option_selects_phases():
    four = chip_smoke.phases_for(4)
    one = chip_smoke.phases_for(1)
    assert set(four) == {"sharded_combined", "sharded_train"}
    assert not set(four) & set(one)
    assert {"bunny_bench", "triangle_deep", "cornell_nee",
            "train_cornell_diff", "accel_vs_brute", "golden"} <= set(one)
    assert set(one) | set(four) == set(chip_smoke.PHASES)
