"""The port's study tools (cli/sweep.py, cli/aggregate.py) against the
JAX package's.

``collect``, ``summarize``, ``negative_transfer`` and ``pairwise_points``
give the JAX functions' results on the same ``result.json`` files, both
ways: files that the port's ``cli.finetune`` writes (chem seeds and a
mutag-style CV fold, through ``cli.sweep``), and files written by hand in
the JAX format (bio runs with their easy and hard test curves and per-task
AUCs, a null task, a CV fold). Floats compare exactly: both run the same
numpy. The two CLIs' flags and defaults are the JAX CLIs' (the sweep adds
``--device``). The sweep runs both blocks of the protocol on the CPU with
the JAX test's arguments (tests/test_sweep_protocol.py): 2 seeds x 2
configs, then 2 dropouts x 2 configs x 2 folds, at full width on 64
synthetic molecules."""

import argparse
import json
import os

import numpy as np
import pytest

from pretrain_gnns_tpu.cli import aggregate as jagg
from pretrain_gnns_tpu.cli import sweep as jsweep
from pretrain_gnns_tpu_torch.cli import aggregate as tagg
from pretrain_gnns_tpu_torch.cli import finetune as tft
from pretrain_gnns_tpu_torch.cli import sweep as tsweep

SWEEP_ARGS = [
    "--datasets", "synthetic", "--seeds", "0", "1",
    "--configs", "nopretrain", "masking",
    "--epochs", "2", "--n_synthetic", "64", "--split", "random",
    "--cv_block", "1", "--cv_datasets", "synthetic",
    "--cv_batch_sizes", "8", "--cv_dropouts", "0.0", "0.5",
    "--cv_folds", "0", "1",
]


def _same(a, b, path="."):
    """Equal JSON-like trees; NaN equals NaN."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            _same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and np.isnan(a):
        assert isinstance(b, float) and np.isnan(b), path
    else:
        assert a == b and type(a) is type(b), (path, a, b)


def _assert_same_analysis(result_dir):
    rows = tagg.collect(result_dir)
    jrows = jagg.collect(result_dir)
    key = lambda r: (r["dataset"], r["config"], r["seed"])  # noqa: E731
    rows, jrows = sorted(rows, key=key), sorted(jrows, key=key)
    assert rows
    _same(rows, jrows)
    _same(tagg.summarize(rows), jagg.summarize(jrows))
    for base in ("nopretrain", "masking"):
        _same(tagg.negative_transfer(rows, base),
              jagg.negative_transfer(jrows, base))
        _same(tagg.pairwise_points(rows, base),
              jagg.pairwise_points(jrows, base))
    return rows


@pytest.fixture(scope="module")
def swept(tmp_path_factory):
    """The two-block sweep on the CPU and its result directory."""
    result_dir = str(tmp_path_factory.mktemp("sweep"))
    tsweep.main(SWEEP_ARGS + ["--result_dir", result_dir,
                              "--device", "cpu"])
    return result_dir


def test_sweep_runs_both_blocks_on_the_cpu(swept):
    """The JAX test's 4 + 8 rows: block 1's seeds and block 2's folds of
    each grid cell, every ``acc`` in [0, 1]."""
    summary = json.load(open(os.path.join(swept, "sweep_summary.json")))
    assert len(summary) == 4 + 8
    main = [r for r in summary if "fold" not in r]
    assert {(r["config"], r["seed"]) for r in main} == {
        (c, s) for c in ("nopretrain", "masking") for s in (0, 1)}
    assert all(0.0 <= r["test_auc"] <= 1.0 for r in main)
    cv_rows = [r for r in summary if "fold" in r]
    assert {r["dataset"] for r in cv_rows} == {
        "synthetic_drop0_bsize8", "synthetic_drop0.5_bsize8"}
    assert all(0.0 <= r["acc"] <= 1.0 for r in cv_rows)


def test_aggregate_matches_jax_on_port_results(swept, tmp_path):
    """The port's ``cli.finetune`` files (through the sweep): the same
    rows, summaries, negative transfer and pairwise points as the JAX
    functions'; ``main`` writes them and the scatter plots, as the JAX
    CLI does."""
    rows = _assert_same_analysis(swept)
    assert len(rows) == 12
    out = {}
    for name, mod in (("port", tagg), ("jax", jagg)):
        out[name] = str(tmp_path / f"{name}.json")
        table = mod.main(["--result_dir", swept, "--out", out[name],
                          "--plots_dir", str(tmp_path / name)])
        assert ("synthetic_drop0_bsize8", "masking") in {
            (t["dataset"], t["config"]) for t in table}
    _same(json.load(open(out["port"])), json.load(open(out["jax"])))
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        os.listdir(tmp_path / "jax")) != []


def _write(root, name, payload):
    d = os.path.join(root, name)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "result.json"), "w") as f:
        json.dump(payload, f)


def test_aggregate_matches_jax_on_jax_format_results(tmp_path):
    """Files in the JAX CLI's format, written here: bio seeds with their
    easy and hard test curves and per-task AUCs (one task null), a chem
    dataset and CV folds; both packages' functions give the same
    analysis, and the argmax-val epoch, the fold-as-seed rule and the
    ``*_task_auc`` rows hold."""
    rng = np.random.default_rng(0)
    root = str(tmp_path)
    for config, shift in (("nopretrain", 0.0), ("masking", 0.03),
                          ("contextpred", -0.02)):
        for seed in range(3):
            val = rng.uniform(0.5, 0.9, 5).tolist()
            tasks = (rng.uniform(0.4, 0.9, 6) + shift).tolist()
            tasks[2] = None
            _write(root, f"bio_{config}_{seed}", {
                "dataset": "bio", "config": {"filename": config,
                                             "runseed": seed},
                "val": val, "test": rng.uniform(0.5, 0.9, 5).tolist(),
                "test_easy": rng.uniform(0.5, 0.9, 5).tolist(),
                "test_hard": rng.uniform(0.5, 0.9, 5).tolist(),
                "test_hard_task_auc": tasks})
            _write(root, f"bbbp_{config}_{seed}", {
                "dataset": "bbbp", "config": {"filename": config,
                                              "runseed": seed},
                "val": val, "test": (np.asarray(val) + shift).tolist()})
        for fold in range(2):
            _write(root, f"cv_{config}_{fold}", {
                "dataset": "mutag_drop0.5_bsize8", "fold": fold,
                "config": {"filename": config, "runseed": 0},
                "val": rng.uniform(0.5, 0.9, 4).tolist(),
                "test": rng.uniform(0.5, 0.9, 4).tolist(),
                "metric": "accuracy"})
    rows = _assert_same_analysis(root)
    r = next(r for r in rows if r["dataset"] == "bio"
             and r["config"] == "masking" and r["seed"] == 1)
    raw = json.load(open(os.path.join(root, "bio_masking_1", "result.json")))
    best = int(np.argmax(raw["val"]))
    assert r["best_epoch"] == best + 1
    assert r["test_easy_auc"] == raw["test_easy"][best]
    assert np.isnan(r["test_hard_task_auc"][2])
    cv = [r for r in rows if r["dataset"].startswith("mutag")]
    assert sorted({r["seed"] for r in cv}) == [0, 1]
    per_task = [d for d in tagg.pairwise_points(rows)
                if d["kind"].startswith("per_task")]
    assert len(per_task) == 2 and all(len(d["x"]) == 5 for d in per_task)


def _parser_of(main):
    """The ``ArgumentParser`` that ``main`` builds, caught at its
    ``parse_args``."""
    caught = {}

    def catch(self, *a, **k):
        caught["parser"] = self
        raise SystemExit(0)

    orig = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = catch
    try:
        with pytest.raises(SystemExit):
            main([])
    finally:
        argparse.ArgumentParser.parse_args = orig
    return caught["parser"]


def _flags(parser):
    return {a.dest: (a.default, a.choices, a.nargs, a.type)
            for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("name", ["sweep", "aggregate"])
def test_cli_flags_match_jax(name):
    """The same flags, defaults, choices and types as the JAX CLIs; the
    sweep adds ``--device`` (default ``cuda``) and passes it to
    ``cli.finetune``, whose flag it is."""
    mine, theirs = {"sweep": (tsweep, jsweep),
                    "aggregate": (tagg, jagg)}[name]
    got, want = _flags(_parser_of(mine.main)), _flags(
        _parser_of(theirs.main))
    if name == "sweep":
        assert got.pop("device") == ("cuda", None, None, None)
        assert "device" in _flags(tft.build_parser())
    assert got == want
