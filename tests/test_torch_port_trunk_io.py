"""Trunk interchange between the JAX package and the port, both ways
(train/checkpoints.py of the port: its writer, reader and graft), and a
pretrained trunk at the start of pretraining
(train/pretrain.{trunk_path,trunk_module,graft_trunk},
``run_pretrain(pretrained_trunk=)``, ``cli.pretrain --input_model_file``).

Every file is one the test writes. Sizes: 2 layers, emb 16, 8-graph
batches in the standard layout, the JAX trunks on their XLA path in
float32. Tolerances: loaded tensors exactly equal; the trunks' forwards
rtol 1e-5 / atol 1e-6 (float32 on both sides, another summation order).
About 35 s alone."""

import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pretrain_gnns_tpu.compat import import_params as jimport
from pretrain_gnns_tpu.compat import torch_writer as jwriter
from pretrain_gnns_tpu.core import graphs as jg
from pretrain_gnns_tpu.models import bio as jbio
from pretrain_gnns_tpu.models import chem as jchem
from pretrain_gnns_tpu_torch.cli import pretrain as cli
from pretrain_gnns_tpu_torch.data import synthetic as tsyn
from pretrain_gnns_tpu_torch.data.packing import PackedLoader
from pretrain_gnns_tpu_torch.models import bio as tbio
from pretrain_gnns_tpu_torch.models import chem as tchem
from pretrain_gnns_tpu_torch.train import checkpoints
from pretrain_gnns_tpu_torch.train import pretrain as tpretrain

LAYERS, EMB, BATCH = 2, 16, 8
FWD_TOL = dict(rtol=1e-5, atol=1e-6)
FAMILIES = ["gin", "gcn", "gat", "graphsage"]
STATS = ("running_mean", "running_var", "num_batches_tracked")


def _batch(domain):
    if domain == "bio":
        graphs = tsyn.bio_dataset(BATCH, seed=1)
        pad = {"center_node_idx": BATCH}
    else:
        graphs, pad = tsyn.molecule_dataset(BATCH, seed=1)[0], None
    return next(iter(PackedLoader(graphs, BATCH, shuffle=False,
                                  extra_pad=pad)))


def _jax_batch(p):
    return jg.PackedGraphs(
        node_feat=jnp.asarray(p.node_feat), edge_feat=jnp.asarray(p.edge_feat),
        senders=jnp.asarray(p.senders), receivers=jnp.asarray(p.receivers),
        node_graph=jnp.asarray(p.node_graph),
        node_mask=jnp.asarray(p.node_mask),
        edge_mask=jnp.asarray(p.edge_mask),
        graph_mask=jnp.asarray(p.graph_mask),
        extras={k: jnp.asarray(v) for k, v in p.extras.items()})


def _ports_trunk(domain, gnn_type):
    cls = tbio.GNN if domain == "bio" else tchem.GNN
    return cls(num_layer=LAYERS, emb_dim=EMB, gnn_type=gnn_type)


@pytest.fixture(scope="module", params=[(d, t) for d in ("chem", "bio")
                                        for t in FAMILIES],
                ids=lambda p: f"{p[0]}-{p[1]}")
def jax_trunk(request, tmp_path_factory):
    """A JAX trunk's variables (batch-norm statistics moved off their
    initial values, so that eval mode reads them), its eval-mode forward on
    a batch, and its export through the JAX writer."""
    domain, gnn_type = request.param
    batch = _batch(domain)
    jcls = jbio.GNN if domain == "bio" else jchem.GNN
    model = jcls(num_layer=LAYERS, emb_dim=EMB, gnn_type=gnn_type)
    variables = model.init(jax.random.PRNGKey(5), _jax_batch(batch),
                           train=False)
    variables = {"params": variables["params"],
                 "batch_stats": jax.tree_util.tree_map(
                     lambda v: v * 1.5 + 0.25,
                     variables.get("batch_stats", {}))}
    ref = np.asarray(model.apply(variables, _jax_batch(batch), train=False))
    path = tmp_path_factory.mktemp("trunks") / f"{domain}_{gnn_type}.pth"
    host = jax.tree_util.tree_map(np.asarray, variables)
    jwriter.save_state_dict(jimport.trunk_to_torch(host), str(path))
    return domain, gnn_type, batch, host, ref, path


def test_jax_export_loads_into_the_port(jax_trunk):
    """The JAX writer's legacy file loads strictly into the port's trunk
    (GAT's raw ``att`` and ``bias``, bio's ``mlp.1`` batch norm and
    ``input_node_embeddings`` included), and the port's eval-mode forward
    matches the JAX trunk's."""
    domain, gnn_type, batch, _, ref, path = jax_trunk
    assert not zipfile.is_zipfile(path)
    sd = checkpoints.load_trunk_any(path)
    trunk = _ports_trunk(domain, gnn_type)
    tpretrain.graft_trunk(torch.nn.ModuleDict({"gnn": trunk}), sd, ("gnn",))
    for k, v in trunk.state_dict().items():
        assert torch.equal(v, sd[k]), k
    if gnn_type == "gat":
        assert "gnns.0.att" in sd and "gnns.0.bias" in sd
    if domain == "bio":
        assert "gnns.0.input_node_embeddings.weight" in sd
        if gnn_type == "gin":
            assert "gnns.1.mlp.1.running_var" in sd
    with torch.no_grad():
        out = trunk(batch.to("cpu"), train=False)
    np.testing.assert_allclose(out.numpy(), ref, **FWD_TOL)


def test_port_export_loads_into_jax(jax_trunk, tmp_path):
    """The port's writer (``save_trunk_reference_format``) on the trunk
    carried over from JAX: a legacy file that the JAX package's
    ``load_trunk`` reads back into the JAX variables, array for array,
    with the keys of the JAX writer's file."""
    domain, gnn_type, _, host, _, jpath = jax_trunk
    trunk = _ports_trunk(domain, gnn_type)
    checkpoints.graft(trunk, checkpoints.load_trunk_any(jpath))
    path = tmp_path / "port.pth"
    checkpoints.save_trunk_reference_format(trunk, path)
    assert not zipfile.is_zipfile(path)
    back = jimport.load_trunk(str(path))
    got = jax.tree_util.tree_leaves_with_path(back)
    want = jax.tree_util.tree_leaves_with_path(host)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (p, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b, err_msg=str(p))
    assert list(torch.load(path)) == list(trunk.state_dict())
    assert sorted(torch.load(path)) == sorted(torch.load(jpath))


@pytest.mark.parametrize("domain", ["chem", "bio"])
def test_trunk_without_batch_count_loads(domain, tmp_path):
    """A file without ``num_batches_tracked`` (torch 1.0.1 wrote none)
    loads strictly, each count 0; the trunk writes the count back."""
    trunk = _ports_trunk(domain, "gin")
    sd = {k: v for k, v in trunk.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    assert any(k.endswith("running_mean") for k in sd)
    path = tmp_path / "old.pth"
    torch.save(sd, path, _use_new_zipfile_serialization=False)
    other = _ports_trunk(domain, "gin")
    for m in other.modules():  # counts that must be reset to 0
        if hasattr(m, "num_batches_tracked"):
            m.num_batches_tracked.fill_(3)
    checkpoints.graft(other, checkpoints.load_trunk_any(path))
    counts = [v for k, v in other.state_dict().items()
              if k.endswith("num_batches_tracked")]
    assert counts and all(int(c) == 0 for c in counts)


@pytest.mark.parametrize("fault", ["stray", "missing", "shape"])
def test_a_wrong_trunk_raises(fault):
    sd = _ports_trunk("chem", "gin").state_dict()
    if fault == "stray":
        sd["gnns.0.mlp.9.weight"] = torch.zeros(2)
    elif fault == "missing":
        del sd["gnns.1.mlp.2.bias"]
    else:
        sd["x_embedding1.weight"] = torch.zeros(120, EMB + 1)
    with pytest.raises(RuntimeError, match="state_dict"):
        checkpoints.graft(_ports_trunk("chem", "gin"), sd)
    with pytest.raises(RuntimeError):  # a bio file into a chem trunk
        checkpoints.graft(_ports_trunk("chem", "gin"),
                          _ports_trunk("bio", "gin").state_dict())


def test_reader_takes_every_format(tmp_path):
    """Legacy files of either writer and torch's zip format read alike;
    anything but a state dict of tensors raises."""
    trunk = _ports_trunk("bio", "gat")
    sd = trunk.state_dict()
    files = {"port": tmp_path / "port.pth", "jax": tmp_path / "jax.pth",
             "zip": tmp_path / "zip.pth"}
    checkpoints.save_trunk_reference_format(trunk, files["port"])
    jwriter.save_state_dict({k: v.numpy() for k, v in sd.items()},
                            str(files["jax"]))
    torch.save(sd, files["zip"])
    assert zipfile.is_zipfile(files["zip"])
    for name, path in files.items():
        got = checkpoints.load_trunk_any(path)
        assert list(got) == list(sd), name
        for k in sd:
            assert got[k].dtype == sd[k].dtype and torch.equal(got[k],
                                                               sd[k]), k
    bad = tmp_path / "bad.pth"
    torch.save([torch.zeros(2)], bad)
    with pytest.raises(ValueError, match="state dict"):
        checkpoints.load_trunk_any(bad)


# --- a pretrained trunk at the start of pretraining ------------------------


def _pretrain_cfg(objective, **kw):
    return tpretrain.PretrainConfig(
        objective=objective, num_layer=LAYERS, emb_dim=EMB, batch_size=16,
        csize=2, lr=0.0, seed=0, **kw)


def _pretrain_graphs(objective):
    graphs, _ = tsyn.molecule_dataset(40, num_tasks=3, seed=2, mean_atoms=12)
    if objective == "supervised":
        graphs, _ = tpretrain.supervised_graphs(graphs, "chem")
    return graphs


@pytest.fixture(scope="module")
def chem_gin_file(tmp_path_factory):
    """A chem GIN trunk exported by the JAX writer."""
    batch = _batch("chem")
    variables = jchem.GNN(num_layer=LAYERS, emb_dim=EMB).init(
        jax.random.PRNGKey(9), _jax_batch(batch), train=False)
    path = tmp_path_factory.mktemp("chem") / "gin.pth"
    jwriter.save_state_dict(jimport.trunk_to_torch(
        jax.tree_util.tree_map(np.asarray, variables)), str(path))
    return path


def _params_equal(trunk, sd):
    for k, v in trunk.state_dict().items():
        if not k.endswith(STATS):
            assert torch.equal(v, sd[k]), k


@pytest.mark.parametrize("objective", ["masking", "supervised",
                                       "contextpred"])
def test_run_pretrain_starts_from_the_trunk(objective, chem_gin_file):
    """At lr 0 one epoch moves only the batch-norm statistics: the trunk
    at ``trunk_path`` holds the file's parameters, every other parameter
    (heads; contextpred's context trunk) the seeded draws."""
    cfg = _pretrain_cfg(objective, num_tasks=3)
    sd = checkpoints.load_trunk_any(chem_gin_file)
    res = tpretrain.run_pretrain(cfg, _pretrain_graphs(objective), log=None,
                                 epochs=1, device="cpu", pretrained_trunk=sd)
    assert res["history"][0]["steps"] >= 1
    path = tpretrain.trunk_path(cfg)
    assert path == {"masking": ("gnn",), "supervised": ("pred", "gnn"),
                    "contextpred": ("gnn_substruct",)}[objective]
    model = res["model"]
    _params_equal(tpretrain.trunk_module(model, path), sd)
    trunk_names = {".".join(path) + "." + k
                   for k in tpretrain.trunk_module(model, path).state_dict()}
    seeded = dict(tpretrain.build_objective(cfg).named_parameters())
    rest = [n for n, _ in model.named_parameters() if n not in trunk_names]
    assert rest
    for n, p in model.named_parameters():
        if n in rest:
            assert torch.equal(p, seeded[n]), n


@pytest.mark.parametrize("objective", ["masking", "supervised",
                                       "contextpred"])
def test_cli_pretrain_input_model_file(objective, chem_gin_file, tmp_path):
    """``--input_model_file``: the saved trunk at lr 0 holds the input
    file's parameters."""
    out = tmp_path / "out"
    cli.main(["--objective", objective, "--device", "cpu", "--epochs", "1",
              "--num_layer", str(LAYERS), "--emb_dim", str(EMB),
              "--batch_size", "16", "--n_synthetic", "40", "--csize", "2",
              "--lr", "0", "--input_model_file", str(chem_gin_file),
              "--output_model_file", str(out)])
    saved = torch.load(str(out) + ".pth")
    sd = torch.load(chem_gin_file)
    assert sorted(saved) == sorted(sd)
    for k in sd:
        if not k.endswith(STATS):
            assert torch.equal(saved[k], sd[k]), k
