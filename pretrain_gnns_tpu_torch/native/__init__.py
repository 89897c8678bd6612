"""Host-side C++ of the port, loaded with ctypes: the batch packer
(``pack_batch``, ``pack_batch_blocked``), the epoch planner
(``plan_epoch``) and the block-aligned NegativeEdge rejection sampler
(``sample_negatives_blocked``), all in ``packer.cpp``.

The source is compiled at first use with ``g++ -O3 -shared -fPIC`` into
``pretrain_gnns_tpu_torch/_build/libpacker_<hash>.so`` (a directory that
``.gitignore`` lists); the hash covers the source and the flags, so an
unchanged source is not rebuilt. A failed build raises: there is no
fallback.

The C functions trust their pointers, so each wrapper below checks the
dtypes and lengths of its arrays against each other first. Graph-local
endpoints are checked where the arrays are built (``data.flat.FlatGraphs``)
or, for the sampler, here."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "packer.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX = "g++"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P, _I64, _U64 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint64
_SIGNATURES = {
    # dataset arrays (6), graph_ids, n_graphs, fn_bytes, fe_bytes,
    # max_nodes, max_edges, max_graphs, outputs (8)
    "pack_batch": ([_P] * 7 + [_I64] * 6 + [_P] * 8, ctypes.c_int),
    # dataset arrays (6), graph_ids, block_of, n_graphs, fn_bytes, fe_bytes,
    # n_blocks, block_nodes, block_edges, max_graphs, outputs (8), fills (2)
    "pack_batch_blocked": ([_P] * 8 + [_I64] * 7 + [_P] * 10, ctypes.c_int),
    # lens_n, lens_e, order, n, batch_size, n_blocks, block_nodes,
    # block_edges, out_batch, out_nstart, out_estart
    "plan_epoch": ([_P] * 3 + [_I64] * 5 + [_P] * 3, _I64),
    # send, recv, edge_off, graph_ids, n_graphs, lens_n, nstarts, estarts,
    # block_edges, n_blocks, seed, out_pairs, out_mask
    "sample_negatives_blocked": ([_P] * 4 + [_I64, _P, _P, _P, _I64, _I64,
                                             _U64, _P, _P], _I64),
}


def compile_library(src: Path, out: Path, cxx: str = CXX) -> Path:
    """``cxx`` ``CXX_FLAGS`` ``src`` into ``out``, unless ``out`` exists.
    Raises ``RuntimeError`` with the compiler's output if the build
    fails or the compiler cannot be run."""
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(src)]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"{' '.join(cmd)} could not run: {e}") from e
    if r.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{r.stdout}{r.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The packer library, built first if needed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        digest = hashlib.sha256(
            SRC.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
        lib = ctypes.CDLL(str(compile_library(
            SRC, BUILD_DIR / f"libpacker_{digest}.so", CXX)))
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, restype
        _lib = lib
        return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _vec(a, dtype, name: str, n: Optional[int] = None) -> np.ndarray:
    """``a`` as a contiguous vector of ``dtype`` (of length ``n``)."""
    a = np.ascontiguousarray(a, dtype)
    if a.ndim != 1 or (n is not None and len(a) != n):
        raise ValueError(f"{name} must be a vector"
                         + (f" of length {n}" if n is not None else "")
                         + f", got shape {a.shape}")
    return a


def _offsets(off, rows: int, name: str) -> np.ndarray:
    off = _vec(off, np.int64, name)
    if len(off) < 1 or off[0] != 0 or off[-1] != rows or np.any(
            np.diff(off) < 0):
        raise ValueError(f"{name} does not partition its {rows} rows")
    return off


def _dataset(node_feat, node_off, recv, send, edge_feat, edge_off):
    """The flat dataset's arrays, checked against each other."""
    for name, a in (("node_feat", node_feat), ("edge_feat", edge_feat)):
        if not (isinstance(a, np.ndarray) and a.flags.c_contiguous
                and a.ndim >= 1):
            raise ValueError(f"{name} must be a C-contiguous array")
    node_off = _offsets(node_off, len(node_feat), "node_off")
    edge_off = _offsets(edge_off, len(edge_feat), "edge_off")
    if len(node_off) != len(edge_off):
        raise ValueError("node_off and edge_off disagree on the number of "
                         "graphs")
    E = len(edge_feat)
    recv = _vec(recv, np.int32, "recv", E)
    send = _vec(send, np.int32, "send", E)
    return node_feat, node_off, recv, send, edge_feat, edge_off


def _row_bytes(a: np.ndarray) -> int:
    return int(np.prod(a.shape[1:], initial=1)) * a.dtype.itemsize


def pack_batch(node_feat, node_off, recv, send, edge_feat, edge_off,
               graph_ids, max_nodes: int, max_edges: int, max_graphs: int,
               blocks: Optional[Tuple[int, int, int]] = None,
               block_of=None):
    """Packs the graphs ``graph_ids`` of a flat dataset (graph ``i``'s
    nodes at rows ``node_off[i]:node_off[i+1]`` of ``node_feat``, its edges
    likewise, endpoints graph-local in ``recv``/``send``) into new buffers:
    contiguously, or with ``blocks = (n_blocks, block_nodes,
    block_edges)`` graph ``g`` into block ``block_of[g]`` (then the buffers
    are ``n_blocks`` blocks). Returns ``(node_feat, edge_feat, senders,
    receivers, node_graph, node_mask, edge_mask, graph_mask)``, the masks
    as bool; raises ``ValueError("batch exceeds packed buffers")`` if the
    graphs do not fit."""
    node_feat, node_off, recv, send, edge_feat, edge_off = _dataset(
        node_feat, node_off, recv, send, edge_feat, edge_off)
    ids = _vec(graph_ids, np.int64, "graph_ids")
    G = len(ids)
    if G and (ids.min() < 0 or ids.max() >= len(node_off) - 1):
        raise ValueError("a graph id is outside the dataset")
    if blocks is not None:
        n_blocks, bn, be = blocks
        max_nodes, max_edges = n_blocks * bn, n_blocks * be
        block_of = _vec(block_of, np.int64, "block_of", G)
    out = (np.empty((max_nodes,) + node_feat.shape[1:], node_feat.dtype),
           np.empty((max_edges,) + edge_feat.shape[1:], edge_feat.dtype),
           np.empty(max_edges, np.int32), np.empty(max_edges, np.int32),
           np.empty(max_nodes, np.int32), np.empty(max_nodes, np.uint8),
           np.empty(max_edges, np.uint8), np.empty(max_graphs, np.uint8))
    data = (_ptr(node_feat), _ptr(node_off), _ptr(recv), _ptr(send),
            _ptr(edge_feat), _ptr(edge_off))
    lib = load()
    if blocks is None:
        rc = lib.pack_batch(
            *data, _ptr(ids), G, _row_bytes(node_feat),
            _row_bytes(edge_feat), max_nodes, max_edges, max_graphs,
            *map(_ptr, out))
    else:
        fill_n = np.empty(n_blocks, np.int64)
        fill_e = np.empty(n_blocks, np.int64)
        rc = lib.pack_batch_blocked(
            *data, _ptr(ids), _ptr(block_of), G, _row_bytes(node_feat),
            _row_bytes(edge_feat), n_blocks, bn, be, max_graphs,
            *map(_ptr, out), _ptr(fill_n), _ptr(fill_e))
    if rc != 0:
        raise ValueError("batch exceeds packed buffers")
    return out[:5] + tuple(m.view(np.bool_) for m in out[5:])


def plan_epoch(lens_n, lens_e, order, batch_size: int, n_blocks: int,
               block_nodes: int, block_edges: int):
    """Greedy first-fit of the graphs ``order`` (indices into ``lens_n``
    and ``lens_e``) into batches of at most ``batch_size`` graphs and
    ``n_blocks`` blocks of ``(block_nodes, block_edges)``; a graph that
    fits no block starts the next batch. Returns ``(batch, nstart,
    estart, n_batches)``: each ordered graph's batch and its first node
    row and edge slot there. Raises ``ValueError("batch exceeds packed
    buffers")`` if one graph alone exceeds a block."""
    lens_n = _vec(lens_n, np.int64, "lens_n")
    lens_e = _vec(lens_e, np.int64, "lens_e", len(lens_n))
    order = _vec(order, np.int64, "order")
    if len(order) and (order.min() < 0 or order.max() >= len(lens_n)):
        raise ValueError("order holds a graph outside lens_n")
    if batch_size < 1 or n_blocks < 1:
        raise ValueError(f"batch_size={batch_size}, n_blocks={n_blocks}")
    n = len(order)
    batch = np.empty(n, np.int32)
    nstart = np.empty(n, np.int32)
    estart = np.empty(n, np.int32)
    r = load().plan_epoch(_ptr(lens_n), _ptr(lens_e), _ptr(order), n,
                          batch_size, n_blocks, block_nodes, block_edges,
                          _ptr(batch), _ptr(nstart), _ptr(estart))
    if r < 0:
        raise ValueError("batch exceeds packed buffers: a graph is larger "
                         f"than a block of ({block_nodes}, {block_edges})")
    return batch, nstart, estart, int(r)


def _graph_arrays(send, recv, edge_off, lens_n, nstarts):
    """The sampler's inputs as contiguous arrays of their types, checked
    against each other."""
    send = np.ascontiguousarray(send, np.int32)
    recv = np.ascontiguousarray(recv, np.int32)
    edge_off = np.ascontiguousarray(edge_off, np.int64)
    lens_n = np.ascontiguousarray(lens_n, np.int64)
    nstarts = np.ascontiguousarray(nstarts, np.int64)
    G = len(lens_n)
    if len(edge_off) != G + 1 or len(nstarts) != G:
        raise ValueError("edge_off, lens_n and nstarts disagree on the "
                         "number of graphs")
    if (edge_off[0] != 0 or np.any(np.diff(edge_off) < 0)
            or edge_off[-1] != len(send) or len(recv) != len(send)):
        raise ValueError("edge_off does not partition send/recv")
    if len(send) and (min(send.min(), recv.min()) < 0 or np.any(
            np.maximum(send, recv) >= np.repeat(lens_n, np.diff(edge_off)))):
        raise ValueError("a graph-local endpoint is outside its graph")
    ids = np.arange(G, dtype=np.int64)
    return send, recv, edge_off, ids, lens_n, nstarts


def sample_negatives_blocked(send, recv, edge_off, lens_n, nstarts, estarts,
                             block_edges: int, n_blocks: int, seed: int
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """The block-aligned layout: ``send``/``recv`` [E] are the graph-local
    endpoints of the batch's edges, graph ``g``'s at ``[edge_off[g],
    edge_off[g+1])``; ``lens_n``, ``nstarts`` and ``estarts`` [G] give each
    graph's node count, first batch row and first edge slot, whose ``//
    block_edges`` is its block. Returns ``(pairs [n_blocks * (block_edges
    // 2), 2] int32, mask bool)``, each graph's pairs in its block's
    region."""
    send, recv, edge_off, ids, lens_n, nstarts = _graph_arrays(
        send, recv, edge_off, lens_n, nstarts)
    estarts = np.ascontiguousarray(estarts, np.int64)
    if len(estarts) != len(ids):
        raise ValueError("estarts and lens_n disagree on the number of "
                         "graphs")
    if block_edges < 2 or n_blocks < 1:
        raise ValueError(f"block_edges={block_edges}, n_blocks={n_blocks} "
                         "is no block layout")
    half = block_edges // 2
    pairs = np.zeros((n_blocks * half, 2), np.int32)
    m = np.zeros(n_blocks * half, np.uint8)
    r = load().sample_negatives_blocked(
        _ptr(send), _ptr(recv), _ptr(edge_off), _ptr(ids), len(ids),
        _ptr(lens_n), _ptr(nstarts), _ptr(estarts), block_edges, n_blocks,
        seed, _ptr(pairs), _ptr(m))
    if r < 0:
        raise ValueError("blocked negative sampling overflowed a block")
    return pairs, m.view(np.bool_)
