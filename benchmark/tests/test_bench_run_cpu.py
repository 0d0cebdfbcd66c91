"""A run without a card exits non-zero and prints no result; the rest of
a run, driven on the CPU at tiny sizes, reads correct where the program
is sound and not correct under each planted fault."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import faults, harness
from benchmark import run as bench_run
from benchmark.tests.tiny import SEED, tiny_cell

CPU = torch.device("cpu")


def _run(cmd, cwd):
    env = {k: v for k, v in os.environ.items()
           if k not in ("CUDA_VISIBLE_DEVICES",)}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run(cmd, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


def _has_result(stdout: str) -> bool:
    for line in stdout.splitlines():
        try:
            if "correct" in json.loads(line):
                return True
        except (ValueError, TypeError):
            pass
    return False


@pytest.mark.parametrize("cell", ["nerf_lego_8x256.train",
                                  "nerf_lego_8x256.render",
                                  "inception_v3_800.nerfail_s_400v"])
def test_no_card_no_result(cell):
    p = _run([sys.executable, "benchmark/run.py", "--workload", cell,
              "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
             harness.ROOT)
    assert p.returncode != 0
    assert not _has_result(p.stdout)
    assert "no CUDA device" in p.stderr


def test_without_the_program_no_result(tmp_path):
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run([sys.executable, "benchmark/run.py", "--workload",
              "nerf_lego_8x256.train", "--seed", "1", "--seconds", "1",
              "--trace", "0"], str(tmp_path))
    assert p.returncode != 0 and not _has_result(p.stdout)


@pytest.fixture
def tiny(monkeypatch):
    cells = {n: tiny_cell(n) for n in ("nerf_lego_8x256.train",
                                       "nerf_lego_8x256.render",
                                       "inception_v3_800.nerfail_s_400v")}
    monkeypatch.setattr(harness, "load_cell",
                        lambda name, root=harness.ROOT: cells[name])


def _line(cell, trace=0):
    args = bench_run.parse(["--workload", cell, "--seed", str(SEED),
                            "--seconds", "0.2", "--trace", str(trace)])
    line, checks = bench_run.run_cell(args, CPU)
    assert list(line)[-1] == "checks"
    assert len([c for c in checks if c.startswith("check ")]) == len(
        line["checks"]) and checks[-1].startswith("check ")
    return line


def test_train_sound(tiny):
    line = _line("nerf_lego_8x256.train")
    assert line["correct"] and line["attempted"] > 0
    assert set(line["metrics"]) == {"train_rays_per_s", "setup_s"}
    assert line["device"]["platform"] == "cpu"


def test_render_sound(tiny):
    line = _line("nerf_lego_8x256.render")
    assert line["correct"] and line["attempted"] > 0
    assert set(line["metrics"]) == {"render_rays_per_s", "setup_s"}


def test_trace_run_on_the_cpu_reports_no_device_metric(tiny):
    line = _line("nerf_lego_8x256.train", trace=1)
    assert line["metrics"] == {} and "breakdown" not in line


def test_train_state_unchanged_is_caught(tiny):
    with faults.state_unchanged():
        line = _line("nerf_lego_8x256.train")
    assert not line["correct"]
    assert line["checks"]["change_gap"]["value"] > 0.9


def test_train_half_batch_is_caught(tiny, monkeypatch):
    # the program's batches lose half their rays; the reference's do not
    from benchmark.drivers import nerf_train
    make = nerf_train.make_inputs

    def make_inputs(ctx):
        rig, images, s = make(ctx)
        return rig, images, faults.half_batch(s)

    monkeypatch.setattr(nerf_train, "make_inputs", make_inputs)
    ref_inputs = nerf_train.reference_readings

    def reference_readings(ctx, **kw):
        monkeypatch.setattr(nerf_train, "make_inputs", make)
        return ref_inputs(ctx, **kw)

    monkeypatch.setattr(nerf_train, "reference_readings", reference_readings)
    line = _line("nerf_lego_8x256.train")
    assert not line["correct"]


@pytest.mark.parametrize("kind", ["altered", "half"])
def test_render_faults_are_caught(tiny, kind):
    with faults.render_fault(kind):
        line = _line("nerf_lego_8x256.render")
    assert not line["correct"]


def test_nerfail_s_sound(tiny):
    line = _line("inception_v3_800.nerfail_s_400v")
    assert line["correct"] and line["attempted"] > 0
    assert set(line["metrics"]) == {"nerfail_s_views_per_s", "setup_s"}


@pytest.mark.parametrize("kind", ["altered", "half"])
def test_nerfail_s_faults_are_caught(tiny, kind):
    with faults.attack_step_fault(kind):
        line = _line("inception_v3_800.nerfail_s_400v")
    assert not line["correct"]
    assert line["checks"]["step_sign_miss"]["value"] > \
        line["checks"]["step_sign_miss"]["limit"]


def test_nerfail_s_table_fault_is_caught(tiny):
    with faults.table_fault():
        line = _line("inception_v3_800.nerfail_s_400v")
    assert not line["correct"]
    assert line["checks"]["knn_dist_gap"]["value"] > \
        line["checks"]["knn_dist_gap"]["limit"]
