"""Build the port's CUDA sources at first use and load them with ctypes.

Each library ``_build/lib<name>_<hash>.so`` inside the package (a
directory that ``.gitignore`` lists) has a plain C interface. It is built
from ``csrc/<name>.cu`` by its own ``nvcc`` process or, for a library that
:data:`SOURCES` splits, from several sources, each compiled by its own
``nvcc`` process into an object and the objects then linked; every
process of a :func:`build` starts at once. The hash covers the sources,
every header of ``csrc/`` they include and the flags, so an unchanged
library is not rebuilt and a changed header rebuilds it. A failed build
raises.
:func:`check_tensors` and :func:`stream` serve the wrappers that hand
tensors to those libraries.

:func:`probe` is the port of the TPU package's lowering probe
(``pretrain_gnns_tpu/ops/pallas_spmm.py::_nopad_ok``): once per process,
before :func:`load` hands out the first kernel library, it builds
``csrc/probe.cu``, doubles an ``[8, 300]`` float32 matrix on the card with
:func:`probe_scale2` and compares with ``2 * x`` exactly. The TPU probe
chose between an unpadded and a padded feature layout; every kernel here
takes unpadded 300-wide rows, so a failed probe raises and stops the run.
``launches["probe_scale2"]`` counts the probe kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# Libraries built from more than one source, so that their parts compile in
# parallel: the GAT kernels' and K2's float32 and bfloat16 instantiations.
SOURCES = {"gat": ("gat", "gat_bf16"), "spmm": ("spmm", "spmm_bf16")}

PROBE_SHAPE = (8, 300)  # the TPU probe's: rows no multiple of 32 lanes wide

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
launches: Dict[str, int] = {"probe_scale2": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put it on PATH)")
    return found


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.MULTILINE)


def _with_headers(src: Path) -> List[Path]:
    """``src`` and every file it includes with ``#include "..."``, directly
    or through another such file, in the order first met."""
    files, todo = [], [src]
    while todo:
        path = todo.pop()
        if path in files:
            continue
        files.append(path)
        todo += [path.parent / m.decode()
                 for m in _INCLUDE.findall(path.read_bytes())]
    return files


def sources(name: str) -> List[Path]:
    """The sources of library ``name`` in :data:`CSRC`."""
    return [CSRC / f"{part}.cu" for part in SOURCES.get(name, (name,))]


def _target(name: str) -> Tuple[List[Path], Path]:
    srcs = sources(name)
    digest = hashlib.sha256()
    for src in srcs:
        for path in _with_headers(src):
            digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return srcs, BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def _spawn(cmd: List[str]) -> subprocess.Popen:
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _start(srcs: Sequence[Path], out: Path):
    """Start the ``nvcc`` processes of one library: one for a single source
    (compiled and linked), one a source (objects) for several."""
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    if len(srcs) == 1:
        return [(srcs[0], _spawn([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                                  str(srcs[0])]))], [], tmp, out
    objs = [out.with_name(f"{out.stem}.{src.stem}.{os.getpid()}.o")
            for src in srcs]
    flags = [f for f in NVCC_FLAGS if f != "-shared"]
    return [(src, _spawn([nvcc_path(), *flags, "-c", "-o", str(obj),
                          str(src)])) for src, obj in zip(srcs, objs)], \
        objs, tmp, out


def _finish(started) -> str:
    procs, objs, tmp, out = started
    texts, failed = [], []
    for src, proc in procs:
        text, _ = proc.communicate()
        texts.append(text)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {src.name}:\n{text}")
    try:
        if failed:
            raise RuntimeError("\n".join(failed))
        if objs:  # link the parts
            proc = _spawn([nvcc_path(), "-shared", "-o", str(tmp),
                           *map(str, objs)])
            text, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed to link {out.name}:\n{text}")
        os.replace(tmp, out)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return "".join(texts)


def build(names: Sequence[str]) -> Dict[str, str]:
    """Compile the named libraries, one ``nvcc`` a source, all started
    together. Returns each newly built library's compiler report
    (``-Xptxas -v``)."""
    started = {}
    for name in names:
        srcs, out = _target(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        started[name] = _start(srcs, out)
    reports, failed = {}, []
    for name, s in started.items():
        try:
            reports[name] = _finish(s)
        except RuntimeError as e:
            failed.append(str(e))
    if failed:
        raise RuntimeError("\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed.
    Every library but the probe's own waits for :func:`probe`."""
    if name != "probe":
        probe()
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _, out = _target(name)
            if not out.exists():
                build([name])
            lib = _libs[name] = ctypes.CDLL(str(out))
        return lib


def check_tensors(dev: torch.device, tensors: Iterable[tuple]) -> None:
    """Raise ``ValueError`` unless every ``(tensor, name, shape, dtype,
    must_be_contiguous)`` entry lies on ``dev`` with that shape and dtype
    (and is contiguous where asked): the kernels trust their pointers."""
    for t, name, shape, dtype, contiguous in tensors:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != dtype:
            raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if contiguous and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


ROW_DTYPES = (torch.float32, torch.bfloat16)


def row_dtype(t: torch.Tensor, name: str) -> torch.dtype:
    """``t``'s dtype, which a kernel with bfloat16 variants takes as its
    rows' dtype: float32 or bfloat16, else ``ValueError``."""
    if t.dtype not in ROW_DTYPES:
        raise ValueError(f"{name} has dtype {t.dtype}, expected float32 or "
                         f"bfloat16")
    return t.dtype


def check_compute_dtype(dtype: torch.dtype) -> bool:
    """True for bfloat16, False for float32 (a kernel's compute dtype),
    else ``ValueError``."""
    if dtype not in ROW_DTYPES:
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got "
                         f"{dtype}")
    return dtype == torch.bfloat16


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to the nearest bfloat16 value (ties to even), as
    float32: the Pallas kernels' ``astype(bfloat16)`` of an operand."""
    return t.to(torch.bfloat16).to(torch.float32)


def stream(t: torch.Tensor) -> int:
    """The handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def probe_scale2_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the probe kernel."""
    return 2 * x


def probe_scale2(x: torch.Tensor) -> torch.Tensor:
    """``2 * x`` for a float32 matrix: the probe kernel of
    ``csrc/probe.cu`` on a CUDA tensor (or raises), the plain version on a
    CPU tensor."""
    if not x.is_cuda:
        return probe_scale2_plain(x)
    if x.dim() != 2:
        raise ValueError(f"x must be [rows, F], got {tuple(x.shape)}")
    check_tensors(x.device, [(x, "x", x.shape, torch.float32, True)])
    lib = load("probe")
    lib.pgt_probe_scale2.argtypes = ([ctypes.c_void_p] * 2
                                     + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    lib.pgt_probe_scale2.restype = ctypes.c_int
    out = torch.empty_like(x)
    err = lib.pgt_probe_scale2(x.data_ptr(), out.data_ptr(), x.shape[0],
                               x.shape[1], stream(x))
    if err:
        raise RuntimeError(f"probe launch failed (CUDA error {err})")
    launches["probe_scale2"] += 1
    return out


@functools.cache
def probe() -> bool:
    """Build the probe kernel, launch it once on the current CUDA device
    and compare with ``2 * x`` exactly (one synchronisation a process: a
    success is cached, a failure is not). Raises ``RuntimeError`` naming
    the compiler's report or the CUDA error when the build, the launch or
    the comparison fails."""
    if not torch.cuda.is_available():
        raise RuntimeError("the kernel probe needs a CUDA device")
    rows, F = PROBE_SHAPE
    x = (torch.arange(rows * F, dtype=torch.float32, device="cuda")
         .reshape(rows, F) / 7 - 100)
    out = probe_scale2(x)  # a failed build or launch raises RuntimeError
    try:
        torch.cuda.synchronize()
    except RuntimeError as e:
        raise RuntimeError(f"probe kernel failed on the card: {e}") from e
    want = probe_scale2_plain(x)
    if not torch.equal(out, want):
        bad = int((out != want).sum())
        raise RuntimeError(
            f"probe kernel disagrees with 2 * x on {bad} of {rows * F} "
            f"entries of a [{rows}, {F}] float32 matrix")
    return True
