"""The port's benchmark, ``python -m pretrain_gnns_tpu_torch.bench``: at a
tiny size on the CPU it prints one JSON line with every field the GPU run
prints (each cell's metric, windows, spread and loader; the dtype; the
device); without CUDA and without ``--device cpu`` it exits non-zero and
prints no result; ``--dtype bfloat16_act`` and ``--dtype default`` set
both precision knobs for the run and restore them. About 20 s alone."""

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


def test_bench_bfloat16_act_sets_both_knobs_and_restores_them(capsys):
    """``--dtype bfloat16_act`` runs the cells with bfloat16 activations and
    the kernels' knob at bfloat16 (on the CPU the plain path ignores the
    latter), names both in its line, and leaves the knobs as it found
    them."""
    from pretrain_gnns_tpu_torch.models import inits
    from pretrain_gnns_tpu_torch.ops import spmm

    assert bench.main(TINY + ["--windows", "1", "--dtype",
                              "bfloat16_act"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (out["dtype"], out["kernel_dtype"]) == ("bfloat16_act",
                                                   "bfloat16")
    metric = "masking_pretrain_gin2_16_e2e_edges_per_sec_per_cpu"
    for name in (metric, "bio_" + metric):
        assert min(out[name]["windows"]) > 0
        assert out[name]["final_loss"] > 0
    assert inits.get_compute_dtype() == "float32"
    assert spmm.get_compute_dtype() == "float32"



def test_bench_default_runs_at_the_knobs_defaults_and_restores_them(
        capsys, monkeypatch):
    """``--dtype default`` runs each cell with the model's knob at float32
    and the kernels' at bfloat16 (the knobs' own defaults, the JAX bench's
    ``float32_value`` row), names both in its line, and leaves the knobs
    as it found them (tests/conftest.py pins the kernels' at float32)."""
    from pretrain_gnns_tpu_torch.models import inits
    from pretrain_gnns_tpu_torch.ops import spmm

    seen = []
    run_cell = bench.run_cell

    def spy(cfg, graphs, args):
        seen.append((inits.get_compute_dtype(), spmm.get_compute_dtype()))
        return run_cell(cfg, graphs, args)

    monkeypatch.setattr(bench, "run_cell", spy)
    before = (inits.get_compute_dtype(), spmm.get_compute_dtype())
    assert before != ("float32", "bfloat16")
    assert bench.main(TINY + ["--windows", "1", "--dtype", "default"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (out["dtype"], out["kernel_dtype"]) == ("default", "bfloat16")
    assert seen == [("float32", "bfloat16")] * 2
    metric = "masking_pretrain_gin2_16_e2e_edges_per_sec_per_cpu"
    for name in (metric, "bio_" + metric):
        assert min(out[name]["windows"]) > 0
        assert out[name]["final_loss"] > 0
    assert (inits.get_compute_dtype(), spmm.get_compute_dtype()) == before


def test_bench_windows_hold_whole_groups():
    """A window runs from the mark that closes the epoch before it to the
    mark that closes its last epoch (on the CPU, the host's seconds
    between them) over its epochs' valid edges; a window that does not
    end on a mark (a group that its epochs split) raises."""
    from pretrain_gnns_tpu_torch.train.telemetry import Mark

    res = {"marks": [Mark(e, 1, at) for e, at in ((2, 0.0), (4, 1.0),
                                                  (6, 3.0))],
           "history": [{"epoch": e, "edges": 10} for e in range(1, 7)],
           "epoch_group": 2}
    assert bench.window_rates(res, 2, 2, 2) == [20.0, 10.0]
    assert bench.window_rates(res, 2, 4, 1) == [40 / 3]
    with pytest.raises(ValueError, match="not a multiple"):
        bench.window_rates(res, 2, 1, 1)
