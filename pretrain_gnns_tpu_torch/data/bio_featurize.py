"""Bio (PPI ego-network) featurization — real-data path (port of
``pretrain_gnns_tpu.data.bio_featurize``).

The reference's bio featurizer (``bio/loader.py:15-142``): converts
networkx ego-graphs of the STRING PPI network into host ``Graph`` arrays
and writes them as npz shards (the format every loader consumes, through
``data.datasets``). networkx is only needed at featurization time
(offline, CPU); nothing here touches the GPU.

The reference's ``BioDataset.process()`` deliberately raises — its data
ships pre-processed (``bio/loader.py:193-194``) — so the other real-data
ingestion path is importing that processed file directly; see
``compat.import_pyg``.

Semantics replicated exactly (reference file:line cited per function):
- node features are a dummy ``ones(N, 1) float32`` (bio/loader.py:47-48);
- edge features are 9-dim float ``[w1..w7, self_loop, mask]`` — seven
  STRING evidence channels plus two flag dims that stay 0 at featurize
  time (bio/loader.py:56-68);
- every undirected edge is emitted as two consecutive directed edges
  (bio/loader.py:64-67) — load-bearing for the MaskEdge transform's
  even-index dedup;
- ``species_id`` parsed from the first nx node id ``species.protein``
  (bio/loader.py:77-85), dummy 0 when unparsable;
- ``center_node_idx`` = position of the ego center in node order
  (bio/loader.py:50-51);
- multi-hot GO-term targets for the center node against the allowable
  downstream / pretrain vocabularies (bio/loader.py:92-115).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from pretrain_gnns_tpu_torch.core.graphs import GRAPH, NODE_IDX, Graph

# The reference's species rosters (bio/loader.py:170-181): 'supervised' =
# the 8 GO-labelled species; 'unsupervised' adds the 42 largest unlabelled
# species by node count.
SUPERVISED_SPECIES: Tuple[int, ...] = (
    3702, 6239, 511145, 7227, 9606, 10090, 4932, 7955,
)
UNSUPERVISED_SPECIES: Tuple[int, ...] = SUPERVISED_SPECIES + (
    3694, 39947, 10116, 443255, 9913, 13616, 3847, 4577, 8364, 9823,
    9615, 9544, 9796, 3055, 7159, 9031, 7739, 395019, 88036, 9685,
    9258, 9598, 485913, 44689, 9593, 7897, 31033, 749414, 59729,
    536227, 4081, 8090, 9601, 749927, 13735, 448385, 457427, 3711,
    479433, 479432, 28377, 9646,
)

_EVIDENCE_KEYS = ("w1", "w2", "w3", "w4", "w5", "w6", "w7")


def nx_to_graph(
    g,
    center_id,
    allowable_features_downstream: Optional[Sequence] = None,
    allowable_features_pretrain: Optional[Sequence] = None,
    node_id_to_go_labels: Optional[Dict] = None,
) -> Graph:
    """nx ego-graph -> ``Graph`` (reference ``nx_to_graph_data_obj``,
    bio/loader.py:15-120). Node order = nx iteration order; each undirected
    edge becomes two consecutive directed rows with identical 9-dim
    features. When ``node_id_to_go_labels`` is given, the downstream GO
    multi-hot becomes ``y`` and the pretrain multi-hot a GRAPH extra."""
    nx_node_ids = list(g.nodes())
    n_nodes = len(nx_node_ids)
    index_of = {nid: i for i, nid in enumerate(nx_node_ids)}

    node_feat = np.ones((n_nodes, 1), dtype=np.float32)

    edges, feats = [], []
    for u, v, attr in g.edges(data=True):
        f = np.array(
            [attr[k] for k in _EVIDENCE_KEYS] + [0, 0], dtype=np.float32
        )
        i, j = index_of[u], index_of[v]
        edges.append((i, j))
        feats.append(f)
        edges.append((j, i))
        feats.append(f)
    if edges:
        edge_index = np.array(edges, dtype=np.int64).T
        edge_feat = np.stack(feats)
    else:
        edge_index = np.zeros((2, 0), dtype=np.int64)
        edge_feat = np.zeros((0, 9), dtype=np.float32)

    try:
        species_id = int(str(nx_node_ids[0]).split(".")[0])
    except (ValueError, IndexError):
        species_id = 0  # dummy id for re-converted graphs (no nx ids)

    graph = Graph(node_feat, edge_index, edge_feat)
    graph.extras["center_node_idx"] = (
        np.array([index_of[center_id]], np.int64), NODE_IDX
    )
    graph.extras["species_id"] = (
        np.array([species_id], np.int64), GRAPH
    )

    if node_id_to_go_labels is not None:
        down = np.zeros(len(allowable_features_downstream), np.float32)
        pre = np.zeros(len(allowable_features_pretrain), np.float32)
        if center_id in node_id_to_go_labels:
            go = node_id_to_go_labels[center_id]
            _, di, _ = np.intersect1d(
                allowable_features_downstream, go, return_indices=True
            )
            down[di] = 1
            _, pi, _ = np.intersect1d(
                allowable_features_pretrain, go, return_indices=True
            )
            pre[pi] = 1
        graph.y = down  # go_target_downstream
        graph.extras["go_target_pretrain"] = (pre, GRAPH)
    return graph


def graph_to_nx(g: Graph):
    """``Graph`` -> undirected nx graph (reference ``graph_data_obj_to_nx``,
    bio/loader.py:121-142): walks every 2nd directed edge, keeps the seven
    evidence channels as booleans. Matches the reference quirk that
    isolated nodes are dropped (nodes exist only via add_edge)."""
    import networkx as nx

    G = nx.Graph()
    ei, ea = g.edge_index, g.edge_feat
    for j in range(0, ei.shape[1], 2):
        a, b = int(ei[0, j]), int(ei[1, j])
        w = ea[j].astype(bool)
        if not G.has_edge(a, b):
            G.add_edge(
                a, b, **{k: bool(w[t]) for t, k in enumerate(_EVIDENCE_KEYS)}
            )
    return G


def process_bio_dataset(
    ego_graphs: Sequence,
    center_ids: Sequence,
    out_dir: str,
    allowable_features_downstream: Optional[Sequence] = None,
    allowable_features_pretrain: Optional[Sequence] = None,
    node_id_to_go_labels: Optional[Dict] = None,
    data_type: str = "unsupervised",
) -> int:
    """Featurize a list of (ego nx graph, center node id) into
    ``<out_dir>/data.npz`` + ``meta.json`` — the step the reference never
    shipped (``BioDataset.process`` raises, bio/loader.py:193-194), so the
    on-disk result matches what importing its processed file yields."""
    from pretrain_gnns_tpu_torch.data import datasets

    graphs: List[Graph] = []
    for g, cid in zip(ego_graphs, center_ids):
        graphs.append(
            nx_to_graph(
                g, cid,
                allowable_features_downstream,
                allowable_features_pretrain,
                node_id_to_go_labels,
            )
        )
    num_tasks = (
        len(allowable_features_downstream)
        if node_id_to_go_labels is not None
        else 0
    )
    os.makedirs(out_dir, exist_ok=True)
    datasets.save_graphs(
        graphs, out_dir,
        meta={
            "num_tasks": num_tasks,
            "dataset": f"bio_{data_type}",
            "domain": "bio",
        },
    )
    return len(graphs)
