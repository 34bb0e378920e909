"""chip_smoke.py on the CPU: its refusal without a GPU, its result line,
and every phase at toy size (on the card the same phases run at full
size)."""

import json
import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

TOY = {
    "main": (300, 100, 20_000),
    "hc": (300, 100, 400_000),
    "k55": (120, 150, 20_000),
    "k101": (60, 150, 20_000),
}


@pytest.fixture
def smoke(tmp_path):
    s = chip_smoke.Smoke(
        str(tmp_path), "cpu (test)", seed=3, memory_limit=2_000_000, sizes=TOY
    )
    yield s
    s.close()


def test_main_refuses_without_gpu(monkeypatch, capsys):
    monkeypatch.setattr(chip_smoke, "query_card", lambda: None)
    rc = chip_smoke.main([])
    out, err = capsys.readouterr()
    assert rc != 0
    assert "cpu" in err and "no GPU" in err
    assert '"ok"' not in out


def test_last_line_format():
    line = chip_smoke.last_line("gpu", "NVIDIA H100 80GB HBM3", 1)
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1},
    }
    assert "\n" not in line


def test_phase_count_main_both_tables(smoke, capsys):
    done = chip_smoke.phase_count(smoke, "main", "main", 31, True, runs=2)
    assert smoke.failures == []
    assert sorted(done) == ["one", "two"]
    assert all(len(runs) == 2 for runs in done.values())
    out = capsys.readouterr().out
    assert "byte_exact=True" in out and "[card: cpu (test)]" in out


@pytest.mark.parametrize("data,k,canonical", [("k55", 55, False), ("k101", 101, True)])
def test_phase_count_wide(smoke, data, k, canonical):
    done = chip_smoke.phase_count(smoke, data, data, k, canonical)
    assert smoke.failures == []
    assert sorted(done) == ["one", "two"]


def test_phase_count_high_cardinality(smoke):
    done = chip_smoke.phase_count(smoke, "hc", "hc", 31, True)
    assert smoke.failures == []
    (_, stats), = done["one"]
    # ~1x coverage of a large genome: nearly every key is distinct
    assert stats.distinct_kmers > 0.9 * stats.total_kmers


def test_spill_phase(smoke):
    chip_smoke.spill_phase(smoke, table_slots=4000)
    assert smoke.failures == []


def test_spill_phase_fails_without_spill(smoke):
    chip_smoke.spill_phase(smoke, table_slots=1_000_000)
    assert any("spilled runs" in f for f in smoke.failures)


def test_memory_analysis(smoke, capsys):
    chip_smoke.memory_analysis(smoke, 31, True, 100)
    out = capsys.readouterr().out
    for name in ("one: consolidate", "two: consolidate2", "two: count_step_two_level"):
        assert name in out


def test_phase_stages(smoke, capsys):
    chip_smoke.phase_stages(smoke, distinct=500, reps=1)
    assert smoke.failures == []
    out = capsys.readouterr().out
    assert "consolidate2 whole" in out and "merge sort" in out


def test_sort_lowering_counts_sorts():
    hlo = (
        '%s = u32[8]{0} sort(u32[8]{0} %a), dimensions={0}\n'
        '%c = (u32[8]{0}) custom-call(%a), custom_call_target="__cub$DeviceRadixSort"\n'
    )
    assert chip_smoke.sort_lowering(hlo) == (
        "custom-call sorts=['__cub$DeviceRadixSort'] generic sort ops=1"
    )


def test_script_alone_fails(tmp_path):
    import shutil
    import subprocess

    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"],
        cwd=tmp_path,
        env=env,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
