"""chip_smoke.py on the CPU: it refuses to run without a GPU, and its
phase functions, called directly at toy size, hold every comparison."""

import os
import shutil
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.abspath(os.path.join(HERE, os.pardir))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

TOY = chip_smoke.Sizes(
    genome=300_000, filter_bits=1 << 22, big=400_000, big_bits=1 << 23,
    gate_slice=100_000, snv=200_000, reads_genome=60_000, coverage=30.0,
    threads=2,
)


def _run_script(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_refuses_cpu_backend():
    res = _run_script(REPO, os.path.join(REPO, "chip_smoke.py"))
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
    assert "needs a GPU" in res.stderr


def test_refuses_outside_a_checkout(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    res = _run_script(str(tmp_path), str(tmp_path / "chip_smoke.py"))
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


@pytest.fixture()
def ctx(tmp_path, monkeypatch):
    # the device filter builds run compiled for the CPU backend
    monkeypatch.setenv("NTEDIT_TPU_DEVICE_BUILD", "1")
    return {"work": str(tmp_path)}


def _check(res):
    assert res.pop("ok") is True, res
    return res


def test_phases_build_and_polish_plain(ctx):
    res = _check(chip_smoke.phase_build(ctx, TOY))
    assert res["blocked_identical"] and res["plain_identical"]
    res = _check(chip_smoke.phase_polish_plain(ctx, TOY))
    assert res["edited_identical_to_baseline"]
    assert sum(res["baseline_edits"]) > 0


def test_phases_polish_blocked_and_snv(ctx):
    res = _check(chip_smoke.phase_polish_blocked(ctx, TOY))
    assert all(res["outputs_identical"].values())
    assert res["slice_gates_identical"] and res["slice_gates"] > 0
    assert res["dense_pass"]["chunks"] == 1
    res = _check(chip_smoke.phase_snv(ctx, TOY))
    assert all(res["outputs_identical"].values()) and res["records"] > 0


def test_phase_polish_reads(ctx):
    res = _check(chip_smoke.phase_polish_reads(ctx, TOY))
    assert res["read_filter_identical"]
    assert all(res["outputs_identical"].values()) and res["records"] > 0


def test_phase_sharded_on_virtual_devices(ctx):
    """The four-card mesh path on four of the test session's virtual CPU
    devices: ring-OR filter and sharded polish equal one device."""
    res = _check(chip_smoke.phase_sharded(ctx, TOY, n_dev=4))
    assert res["ring_or_filter_identical"]
    assert all(res["outputs_identical"].values())
