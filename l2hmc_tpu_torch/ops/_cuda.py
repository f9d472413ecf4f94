"""Builds and loads the CUDA kernels of ``l2hmc_tpu_torch/csrc``.

Each ``.cu`` source becomes one shared library with a plain C interface,
compiled by ``nvcc`` for ``sm_90a`` at first use and loaded with ``ctypes``.
The libraries go to ``l2hmc_tpu_torch/_build/<hash>/``, keyed by a hash of
every source and the flags, so an edited source is rebuilt and an unchanged
one is loaded from the previous build. All sources are compiled together,
one ``nvcc`` process each. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD = Path(__file__).resolve().parent.parent / "_build"
_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
]
# the entry points of each library: name -> ctypes argtypes
_P, _I, _U64, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64, ctypes.c_float
SIGNATURES = {
    "trajectory": {
        "l2hmc_trajectory": [_P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _I, _P],
    },
    "trajectory_bwd": {
        "l2hmc_trajectory_bwd": [_P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                                 _P, _P, _I, _P],
    },
    "chain": {
        "l2hmc_chain": [_P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _I, _I, _U64, _P],
    },
    "vae_chain": {
        "l2hmc_vae_chain": [_P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                            _I, _I, _I, _U64, _P],
    },
    "vae_ais": {
        "l2hmc_vae_ais": [_P, _I, _I, _I, _P, _P, _P, _P, _P, _F, _F, _I, _I, _I, _I,
                          _U64, _P],
    },
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_info: dict = {}  # seconds, directory and ptxas report of the last build


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for p in sorted(_CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _build_all(out_dir: Path) -> None:
    """Compiles every source in parallel into ``out_dir``; raises with the
    compiler's output if any fails."""
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name in SIGNATURES:
        tmp = out_dir / f"lib{name}.so.tmp{os.getpid()}"
        cmd = [nvcc, *_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    logs, failed = {}, []
    for name, (tmp, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, out_dir / f"lib{name}.so")  # atomic for racing builds
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(failed) + ":\n"
            + "\n".join(logs[n] for n in failed)
        )
    (out_dir / "ptxas.log").write_text("\n".join(logs.values()))
    build_info.update(seconds=time.perf_counter() - t0, dir=str(out_dir),
                      ptxas="\n".join(logs.values()))


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (a key of ``SIGNATURES``), building all
    sources first if this source hash has no build yet."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        out_dir = _BUILD / _source_hash()
        if not all((out_dir / f"lib{n}.so").exists() for n in SIGNATURES):
            _build_all(out_dir)
        else:
            build_info.update(seconds=0.0, dir=str(out_dir),
                              ptxas=(out_dir / "ptxas.log").read_text())
        for lib_name, fns in SIGNATURES.items():
            cdll = ctypes.CDLL(str(out_dir / f"lib{lib_name}.so"))
            for fn, argtypes in fns.items():
                f = getattr(cdll, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _libs[lib_name] = cdll
        return _libs[name]


def check(err: int, what: str) -> None:
    """Raises if a launcher returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what} launch failed with CUDA error {err}")
