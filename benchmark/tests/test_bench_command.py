"""The command refuses a machine without the cell's cards, and a
checkout that holds only the benchmark: no result, a code other than 0."""
import os
import shutil
import subprocess
import sys

from .conftest import REPO

ARGS = ["--workload", "standin_static_1080p", "--seed", str(2**31 + 11),
        "--seconds", "1", "--trace", "0"]


def _run(cwd, env=None):
    return subprocess.run([sys.executable, "benchmark/run.py", *ARGS],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def test_refuses_a_machine_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    done = _run(REPO, env)
    assert done.returncode == 2
    assert done.stdout.strip() == ""
    assert "no CUDA device" in done.stderr


def test_refuses_a_checkout_of_the_benchmark_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(REPO, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    env = dict(os.environ, PYTHONPATH="")
    done = _run(str(tmp_path), env)
    assert done.returncode != 0
    assert done.stdout.strip() == ""
