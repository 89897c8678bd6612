"""The port's benchmark, ``python -m pretrain_gnns_tpu_torch.bench``: at a
tiny size on the CPU it prints one JSON line with every field the GPU run
prints (each cell's metric, windows, spread and loader; the dtype; the
device); without CUDA and without ``--device cpu`` it exits non-zero and
prints no result. About 10 s alone."""

import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from pretrain_gnns_tpu_torch import bench

ROOT = pathlib.Path(__file__).resolve().parent.parent
TINY = ["--device", "cpu", "--graphs", "96", "--bio_graphs", "64",
        "--num_layer", "2", "--emb_dim", "16", "--batch_size", "16",
        "--windows", "3", "--window_epochs", "1"]


def test_bench_prints_one_json_line_on_the_cpu(capsys):
    assert bench.main(TINY) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    metric = "masking_pretrain_gin2_16_e2e_edges_per_sec_per_cpu"
    assert out["metric"] == metric and out["value"] == out[metric]["value"]
    assert out["dtype"] == "float32" and out["device"] == "cpu"
    assert out["card"] is None  # no GPU name on a CPU run
    for name, steps in ((metric, 6), ("bio_" + metric, 4)):
        cell = out[name]
        assert cell["loader"] == "FlatLoader"
        assert len(cell["windows"]) == 3 and min(cell["windows"]) > 0
        assert sorted(cell["windows"])[1] == cell["value"]
        assert cell["spread"] == pytest.approx(
            (max(cell["windows"]) - min(cell["windows"])) / cell["value"])
        assert cell["steps_per_epoch"] == steps
        assert cell["edges_per_epoch"] > 0 and cell["final_loss"] > 0


def test_bench_without_cuda_exits_non_zero():
    if torch.cuda.is_available():
        pytest.skip("checks the CUDA-less behaviour")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-m", "pretrain_gnns_tpu_torch.bench",
                        *TINY[2:]], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode != 0 and not r.stdout.strip()
    assert "no CUDA device" in r.stderr
