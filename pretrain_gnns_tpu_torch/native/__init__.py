"""Host-side C++ of the port, loaded with ctypes: the NegativeEdge
rejection sampler (``negatives.cpp``) in its block-aligned layout.

The source is compiled at first use with ``g++ -O3 -shared -fPIC`` into
``pretrain_gnns_tpu_torch/_build/libnegatives_<hash>.so`` (a directory
that ``.gitignore`` lists); the hash covers the source and the flags, so
an unchanged source is not rebuilt. A failed build raises: there is no
fallback."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "negatives.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P, _I64, _U64 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint64


def load() -> ctypes.CDLL:
    """The sampler library, built first if needed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        digest = hashlib.sha256(
            SRC.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
        out = BUILD_DIR / f"libnegatives_{digest}.so"
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(SRC)]
            r = subprocess.run(cmd, capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(
                    f"{' '.join(cmd)} failed:\n{r.stdout}{r.stderr}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        lib.sample_negatives_blocked.argtypes = (
            [_P] * 4 + [_I64, _P, _P, _P, _I64, _I64, _U64, _P, _P])
        lib.sample_negatives_blocked.restype = _I64
        _lib = lib
        return lib


def _graph_arrays(send, recv, edge_off, lens_n, nstarts):
    """The sampler's inputs as contiguous arrays of its types, checked
    against each other: it trusts its pointers."""
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


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def sample_negatives_blocked(send, recv, edge_off, lens_n, nstarts, estarts,
                             block_edges: int, n_blocks: int, seed: int
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """``send``/``recv`` [E] are the graph-local endpoints of the batch's
    edges, graph ``g``'s at ``[edge_off[g], edge_off[g+1])``; ``lens_n``,
    ``nstarts`` and ``estarts`` [G] give each graph's node count, first
    batch row and first edge slot, whose ``// block_edges`` is its block.
    Returns ``(pairs [n_blocks * (block_edges // 2), 2] int32, mask
    bool)``, each graph's pairs in its block's region."""
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
    return pairs, m.astype(bool)
