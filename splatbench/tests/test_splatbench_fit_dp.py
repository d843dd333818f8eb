"""The ``fit_dp`` kind on a CPU world of 4 gloo ranks at a small size
(``dp_ranks.py``, one process a rank): a sound run is correct against the
reference and the calibration's control and faults are not; the exchange
left out and a quarter of the views, put underneath the program in every
rank, come out not correct; a traced run counts the bytes the exchange
reduced; and a rank that dies, or a rank 0 that raises, ends the run
within a minute with no rank process left."""

import json
import re
import subprocess
import sys
import time

import pytest

from helpers import HERE_TESTS

HELPER = HERE_TESTS / "dp_ranks.py"
ROOT = HERE_TESTS.parents[1]


def _lead(tmp_path, fault, *flags, seconds=1.0):
    out = tmp_path / "lead.json"
    res = subprocess.run(
        [sys.executable, str(HELPER), "--lead", str(out), "--fault", fault,
         "--seconds", str(seconds), "--marker", str(tmp_path / "struck"),
         *flags], cwd=ROOT, capture_output=True, text=True, timeout=400)
    return res, (json.loads(out.read_text()) if out.exists() else None)


def _alive(pid: int) -> bool:
    """Whether ``pid`` runs (a zombie does not)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except FileNotFoundError:
        return False


def test_sound_run_is_correct_and_the_calibration_faults_are_not(tmp_path):
    res, got = _lead(tmp_path, "none", "--traced", "--readings")
    assert res.returncode == 0, res.stderr[-4000:]
    assert got["correct"] and got["failed"] == 0
    assert got["numbers"]["rank_gap"] == 0.0
    assert got["readings"].pop("sound")
    assert set(got["readings"]) == {"control_bf16", "fault_quarter_views",
                                    "fault_exchange_left_out",
                                    "fault_state_unchanged"}
    assert not any(got["readings"].values()), got["readings"]
    tr = got["trace"]
    assert tr["allreduce_calls"] == tr["units"] == 2 and tr["ranks"] == 4
    assert tr["allreduce_bytes"] == 2 * (59 * got["n"] + 1) * 4
    assert "nccl_ms.step" in got["metrics"]


@pytest.mark.parametrize("fault", ["exchange_left_out", "quarter_views"])
def test_fault_is_caught(tmp_path, fault):
    res, got = _lead(tmp_path, fault)
    assert res.returncode == 0, res.stderr[-4000:]
    assert not got["correct"], got["numbers"]


@pytest.mark.parametrize("fault", ["kill_rank", "raise_rank0"])
def test_failing_rank_ends_the_run(tmp_path, fault):
    res, got = _lead(tmp_path, fault, seconds=300.0)
    ended = time.time()
    assert res.returncode != 0 and got is None
    assert ended - (tmp_path / "struck").stat().st_mtime < 60.0
    pids = [int(p) for p in re.search(r"ranks: pid ([\d ]+)",
                                      res.stderr).group(1).split()]
    assert len(pids) == 3
    assert not any(_alive(p) for p in pids)
