"""Three faults of the port against the JAX package, repaired:

- F7: under JK concat, the chem masking heads' biases are drawn from
  U(-1/sqrt(emb_dim), 1/sqrt(emb_dim)), the JAX ``inits.dense`` bias bound,
  while their weights keep 1/sqrt(in_features); under JK last the seeded
  initial state dict is what it was.
- F8: the CLI writes its trunk in torch's legacy non-zip format, as the JAX
  CLI does, which the reference's torch 1.0.1 reads.
- F4 (``--split``): the CLI's bio supervised pretraining trains on the
  species split by default, as the JAX CLI's does; its pretrain set equals
  the JAX CLI's index for index under ``species`` and ``random``.

Sizes: 2 layers, emb 300 for F7 (the bounds are then 1/sqrt(300) against
1/sqrt(900)), emb 16 for F8. About 25 s alone."""

import math
import zipfile

import jax
import numpy as np
import pytest
import torch
from torch import nn

from pretrain_gnns_tpu.compat import import_params
from pretrain_gnns_tpu.core import graphs as jg
from pretrain_gnns_tpu.data import packing as jpk
from pretrain_gnns_tpu.data import synthetic as jsyn
from pretrain_gnns_tpu.models import bio as jbio
from pretrain_gnns_tpu.models import chem as jchem
from pretrain_gnns_tpu.objectives.masking import (
    MaskingObjective as JaxMasking,
)
from pretrain_gnns_tpu.train.checkpoints import save_trunk_reference_format
from pretrain_gnns_tpu_torch.cli import pretrain as cli
from pretrain_gnns_tpu_torch.compat.from_jax import state_dict_from_jax
from pretrain_gnns_tpu_torch.models import bio as tbio
from pretrain_gnns_tpu_torch.models import chem as tchem
from pretrain_gnns_tpu_torch.models.inits import init_parameters
from pretrain_gnns_tpu_torch.train import pretrain as tpretrain

LAYERS, EMB = 2, 300
HEADS = ("linear_pred_atoms", "linear_pred_bonds")


def _cfg(jk):
    return tpretrain.PretrainConfig(num_layer=LAYERS, emb_dim=EMB, jk=jk,
                                    mask_edge=True, seed=4)


def _jax_heads(jk, seed):
    """The JAX masking objective's initial head parameters."""
    graphs, _ = jsyn.molecule_dataset(8, seed=0)
    batch = jg.pack_graphs(graphs, 512, 1024, 8)
    n = int(np.asarray(batch.node_mask).sum())
    e = int(np.asarray(batch.edge_mask).sum())
    batch = batch.replace(extras={
        "masked_atom_indices": np.arange(4, dtype=np.int32),
        "masked_atom_indices_mask": np.ones(4, bool),
        "mask_node_label": np.zeros((4, 2), np.int32),
        "connected_edge_indices": np.arange(0, 8, 2, dtype=np.int32),
        "connected_edge_indices_mask": np.ones(4, bool),
        "mask_edge_label": np.zeros((4, 2), np.int32)})
    assert n > 4 and e > 8
    m = JaxMasking(num_layer=LAYERS, emb_dim=EMB, jk=jk, mask_edge=True)
    params = m.init(jax.random.PRNGKey(seed), batch, train=False)["params"]
    return {h: {k: np.asarray(v) for k, v in params[h].items()}
            for h in HEADS}


def test_concat_head_bounds_match_jax():
    """JK concat: both heads' weights within 1/sqrt(rep), rep = 3 x 300,
    and their biases from U(+-1/sqrt(300)), in the port and in the JAX
    package alike: the 119 atom biases reach beyond 1/sqrt(rep)."""
    rep = (LAYERS + 1) * EMB
    port = tpretrain.build_objective(_cfg("concat"))
    for seed in (0, 1):
        jax_heads = _jax_heads("concat", seed)
        for h in HEADS:
            w, b = jax_heads[h]["kernel"], jax_heads[h]["bias"]
            assert np.abs(w).max() <= rep ** -0.5
            assert np.abs(b).max() <= EMB ** -0.5
        assert np.abs(jax_heads["linear_pred_atoms"]["bias"]).max() > (
            rep ** -0.5)
    for h in HEADS:
        lin = getattr(port, h)
        assert lin.in_features == rep and lin.bias_fan_in == EMB
        assert float(lin.weight.detach().abs().max()) <= rep ** -0.5
        assert float(lin.bias.detach().abs().max()) <= EMB ** -0.5
    assert float(port.linear_pred_atoms.bias.detach().abs().max()) > (
        rep ** -0.5)


def _pre_repair(jk):
    """The objective as it was drawn before the repair: plain
    ``nn.Linear`` heads (bias bound 1/sqrt(in_features)), in the same
    module order, from the same seed."""
    model = tpretrain.build_objective(_cfg(jk))
    for h in HEADS:
        lin = getattr(model, h)
        setattr(model, h, nn.Linear(lin.in_features, lin.out_features))
    init_parameters(model, torch.Generator().manual_seed(_cfg(jk).seed))
    return model


@pytest.mark.parametrize("jk", ["last", "concat"])
def test_head_biases_keep_the_draws(jk):
    """The same draws as before the repair: under JK last the whole
    initial state dict is bit for bit the old one; under concat only the
    two head biases differ, by the ratio of the bounds exactly."""
    new = tpretrain.build_objective(_cfg(jk)).state_dict()
    old = _pre_repair(jk).state_dict()
    assert list(new) == list(old)
    rep = (LAYERS + 1) * EMB if jk == "concat" else EMB
    for k in new:
        if jk == "concat" and k in {f"{h}.bias" for h in HEADS}:
            np.testing.assert_allclose(
                new[k].numpy() * math.sqrt(EMB),
                old[k].numpy() * math.sqrt(rep), rtol=1e-5, atol=1e-7,
                err_msg=k)
            assert not torch.equal(new[k], old[k])
        else:
            assert torch.equal(new[k], old[k]), k


@pytest.mark.parametrize("domain", ["chem", "bio"])
def test_cli_trunk_export_is_legacy_and_equals_jax(tmp_path, domain):
    """The CLI's trunk writer on parameters carried from a JAX trunk: not
    a zip file, read by the JAX package's ``load_trunk`` back into those
    parameters, and key for key the JAX CLI's export of them."""
    jtrunk, ttrunk = ((jbio.GNN, tbio.GNN) if domain == "bio"
                      else (jchem.GNN, tchem.GNN))
    graphs = (jsyn.bio_dataset(8, seed=0) if domain == "bio"
              else jsyn.molecule_dataset(8, seed=0)[0])
    batch = jpk.PackedLoader(graphs, 8, shuffle=False,
                             extra_pad={"center_node_idx": 8}).__iter__()
    variables = jtrunk(num_layer=2, emb_dim=16).init(
        jax.random.PRNGKey(3), next(batch), train=False)
    host = jax.tree_util.tree_map(np.asarray, dict(variables))
    trunk = ttrunk(num_layer=2, emb_dim=16)
    trunk.load_state_dict(state_dict_from_jax(
        host["params"], host.get("batch_stats", {})), strict=True)

    ours, theirs = tmp_path / "port.pth", tmp_path / "jax.pth"
    cli.save_trunk(trunk, str(ours))
    save_trunk_reference_format(variables, str(theirs))
    assert not zipfile.is_zipfile(ours) and not zipfile.is_zipfile(theirs)
    back = import_params.load_trunk(str(ours))
    flat_back = jax.tree_util.tree_leaves_with_path(back)
    flat_ref = jax.tree_util.tree_leaves_with_path(
        import_params.load_trunk(str(theirs)))
    assert [p for p, _ in flat_back] == [p for p, _ in flat_ref]
    for (path, a), (_, b) in zip(flat_back, flat_ref):
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    for (path, a), (_, b) in zip(
            flat_back, jax.tree_util.tree_leaves_with_path(host)):
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    a, b = torch.load(ours), torch.load(theirs)
    assert sorted(a) == sorted(b)  # the key order is each module tree's
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def test_cli_writes_a_legacy_file(tmp_path):
    out = tmp_path / "trunk"
    cli.main(["--device", "cpu", "--epochs", "1", "--num_layer", "2",
              "--emb_dim", "16", "--batch_size", "16", "--n_synthetic", "32",
              "--output_model_file", str(out)])
    assert not zipfile.is_zipfile(str(out) + ".pth")
    tchem.GNN(num_layer=2, emb_dim=16).load_state_dict(
        torch.load(str(out) + ".pth"), strict=True)


# --- F4: the species split of bio supervised pretraining --------------------


@pytest.mark.parametrize("split", ["species", "random"])
@pytest.mark.parametrize("seed", [0, 3])
def test_bio_supervised_pretrain_indices_equal_jax(split, seed):
    from pretrain_gnns_tpu.cli import pretrain as jcli
    from pretrain_gnns_tpu_torch.data import synthetic as tsyn

    graphs = tsyn.bio_dataset(96, seed=seed)
    species = np.array([g.extras["species_id"][0][0] for g in graphs])
    got = cli.bio_supervised_pretrain_indices(species, split, seed)
    assert got == jcli.bio_supervised_pretrain_indices(species, split, seed)
    assert 0 < len(got) < len(graphs) and len(set(got)) == len(got)
    with pytest.raises(ValueError):
        cli.bio_supervised_pretrain_indices(species, "scaffold", seed)


def test_split_flag_has_the_jax_default_and_choices():
    from pretrain_gnns_tpu.cli import pretrain as jcli

    def split_action(parser):
        return next(a for a in parser._actions if a.dest == "split")

    mine, ref = split_action(cli.build_parser()), split_action(
        jcli.build_parser())
    assert (mine.default, list(mine.choices)) == (ref.default,
                                                  list(ref.choices))
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["--split", "scaffold"])


@pytest.mark.parametrize("split", ["species", "random"])
def test_bio_supervised_cli_trains_on_the_split(monkeypatch, split):
    """The CLI hands run_pretrain the split's graphs, in its order, with
    their pretraining labels in y."""
    from pretrain_gnns_tpu_torch.data import synthetic as tsyn

    seen = {}

    def fake_run(cfg, graphs, **kw):
        seen["graphs"] = graphs
        return {"history": [], "model": None}

    monkeypatch.setattr(tpretrain, "run_pretrain", fake_run)
    cli.main(["--objective", "supervised", "--domain", "bio", "--device",
              "cpu", "--split", split, "--n_synthetic", "256", "--seed", "1"])
    graphs = tsyn.bio_dataset(64, seed=1)
    species = np.array([g.extras["species_id"][0][0] for g in graphs])
    keep = cli.bio_supervised_pretrain_indices(species, split, 1)
    assert len(keep) < len(graphs)
    got = seen["graphs"]
    assert len(got) == len(keep)
    for g, i in zip(got, keep):
        np.testing.assert_array_equal(g.node_feat, graphs[i].node_feat)
        np.testing.assert_array_equal(
            g.y, graphs[i].extras["go_target_pretrain"][0])

