"""Builds and loads the CUDA kernels of ``l2hmc_tpu_torch/csrc``.

Each ``.cu`` source becomes one shared library with a plain C interface,
compiled by ``nvcc`` for ``sm_90a`` at first use and loaded with ``ctypes``.
The libraries go to ``l2hmc_tpu_torch/_build/<hash>/``, keyed by a hash of
every source and the flags, so an edited source is rebuilt and an unchanged
one is loaded from the previous build. All sources are compiled together,
one ``nvcc`` process each, in the background (``start_build``): a first
``library(name)`` waits for its own source only, so a caller can run one
library's kernels while the others still compile. Nothing here runs at
import.
"""

from __future__ import annotations

import atexit
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
    # params, D, H, H2, T, energy kind, its constants' floats, ...
    "trajectory": {
        "l2hmc_trajectory": [_P, *([_I] * 8), _P, _P, _P, _P, _P, _I, _P],
        "l2hmc_trajectory_site_chains": [_I, _I, _I],
        "l2hmc_trajectory_site_threads": [_I, _I, _I],
        "l2hmc_trajectory_site_smem_bytes": [_I] * 5,  # D, H, H2, energy kind, constants
    },
    "trajectory_bf16": {
        "l2hmc_trajectory_bf16": [_P, *([_I] * 8), _P, _P, _P, _P, _P, _I, _P],
    },
    "trajectory_bwd": {
        "l2hmc_trajectory_bwd": [_P, *([_I] * 8), *([_P] * 9), _I, _P],
        "l2hmc_trajectory_bwd_site_chains": [_I, _I, _I],
        "l2hmc_trajectory_bwd_site_threads": [_I, _I, _I],
        "l2hmc_trajectory_bwd_site_smem_bytes": [_I] * 5,  # D, H, H2, energy kind, constants
    },
    "trajectory_bwd_specs": {
        "l2hmc_trajectory_bwd_specs": [_P, *([_I] * 8), *([_P] * 9), _I, _P],
    },
    "chain": {
        "l2hmc_chain": [_P, *([_I] * 7), _P, _P, _P, _P, _P, _I, _I, _U64, _P],
        "l2hmc_chain_lanes": [_I, _I, _I],
        "l2hmc_chain_site_chains": [_I, _I, _I],
        "l2hmc_chain_site_threads": [_I, _I, _I],
        "l2hmc_chain_site_smem_bytes": [_I] * 5,  # D, H, H2, energy kind, constants
    },
    "chain_bf16": {
        "l2hmc_chain_bf16": [_P, *([_I] * 7), _P, _P, _P, _P, _P, _I, _I, _U64, _P],
    },
    "vae_chain": {
        "l2hmc_vae_chain": [_P, _I, _I, _I, _I, _I, _I, *([_P] * 8), _I, _I, _U64, _I, _P],
        "l2hmc_vae_chain_sizes": [*([_I] * 7), _P],
        "l2hmc_vae_chain_clusters": [_I] * 6,
    },
    "vae_ais": {
        "l2hmc_vae_ais": [_P, _I, _I, _I, _P, _P, _P, _P, _P, _F, _F, _I, _I, _I,
                          _U64, _I, _P],
        "l2hmc_vae_ais_sizes": [_I, _I, _I, _I, _P],
        "l2hmc_vae_ais_clusters": [_I, _I, _I],
    },
    "vae_traj": {
        "l2hmc_vae_traj": [_P, _I, _I, _I, _I, _I, _I, *([_P] * 8), _I, _I, _I, _P],
        "l2hmc_vae_traj_sizes": [*([_I] * 7), _P],
        "l2hmc_vae_traj_clusters": [_I] * 6,
    },
    "vae_traj_bwd": {
        "l2hmc_vae_traj_bwd": [_P, _I, _I, _I, _I, _I, _I, *([_P] * 14), _I, _I, _I, _P],
        "l2hmc_vae_traj_bwd_sizes": [*([_I] * 7), _P],
        "l2hmc_vae_traj_bwd_clusters": [_I] * 6,
    },
}

# the compilers run this much below the caller's priority, so that the
# caller's own work beside the build (with a library already built) is not
# starved of the host's cores
NICENESS = 10
_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_ready: dict[str, threading.Event] = {}  # set when a source's build has ended
_errors: dict[str, str] = {}  # the compiler's output for each source that failed
_watcher: list = []  # the thread that watches the build under way
build_info: dict = {}  # seconds (and by source), directory and ptxas report of the last build


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


def _watch(out_dir: Path, procs: dict, t0: float) -> None:
    """Waits for the build's processes as they end: moves each library into
    place (atomically, for racing builds), records its seconds and its
    ptxas report, and sets its event; a source that failed keeps its
    compiler output in ``_errors``."""
    logs = {}
    pending = dict(procs)
    try:
        while pending:
            for name, (tmp, log, proc) in list(pending.items()):
                if proc.poll() is None:
                    continue
                del pending[name]
                build_info["seconds_by_source"][name] = time.perf_counter() - t0
                log.seek(0)
                logs[name] = log.read()
                if proc.returncode == 0:
                    os.replace(tmp, out_dir / f"lib{name}.so")
                else:
                    _errors[name] = logs[name]
                build_info["ptxas"] = "\n".join(logs.values())
                _ready[name].set()
            time.sleep(0.05)
        (out_dir / "ptxas.log").write_text("\n".join(logs.values()))
        build_info["seconds"] = time.perf_counter() - t0
    finally:
        for name, (_, _, proc) in pending.items():
            proc.kill()
            _errors.setdefault(name, "the build's watcher stopped before nvcc ended")
        for _, log, _ in procs.values():
            log.close()
            if os.path.exists(log.name):
                os.remove(log.name)
        for event in _ready.values():
            event.set()


def _stop(procs: dict) -> None:
    """At exit: ends the nvcc processes still running and removes their
    partial outputs."""
    for tmp, log, proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        for path in (tmp, log.name):
            try:
                os.remove(path)
            except FileNotFoundError:
                pass


def _start_locked() -> None:
    if _ready:  # started (or found built) before in this process
        return
    out_dir = _BUILD / _source_hash()
    build_info.clear()
    build_info.update(dir=str(out_dir), seconds_by_source={})
    if all((out_dir / f"lib{n}.so").exists() for n in SIGNATURES):
        report = out_dir / "ptxas.log"
        build_info.update(seconds=0.0, ptxas=report.read_text() if report.exists() else "")
        for name in SIGNATURES:
            _ready[name] = threading.Event()
            _ready[name].set()
        return
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    try:
        for name in SIGNATURES:
            tmp = out_dir / f"lib{name}.so.tmp{os.getpid()}"
            log = open(out_dir / f"{name}.log.tmp{os.getpid()}", "w+")
            procs[name] = (tmp, log)
            cmd = [nvcc, *_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
            proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
            procs[name] += (proc,)
            try:
                os.setpriority(os.PRIO_PROCESS, proc.pid,
                               min(19, os.getpriority(os.PRIO_PROCESS, 0) + NICENESS))
            except OSError:  # it has ended already
                pass
    except BaseException:
        for entry in procs.values():
            if len(entry) == 3:
                entry[2].kill()
            entry[1].close()
            os.remove(entry[1].name)
        raise
    atexit.register(_stop, procs)
    build_info["ptxas"] = ""
    for name in SIGNATURES:
        _ready[name] = threading.Event()
    thread = threading.Thread(target=_watch, args=(out_dir, procs, t0), daemon=True)
    thread.start()
    _watcher.append(thread)


def start_build() -> None:
    """Starts compiling every source in the background, one ``nvcc``
    process each, unless this source hash has a build or a build has
    started in this process. Returns at once."""
    with _lock:
        _start_locked()


def wait_build() -> None:
    """Starts the build if it has not started, waits for every source and
    raises with the compiler's output if any failed."""
    start_build()
    for event in list(_ready.values()):
        event.wait()
    for thread in _watcher:
        thread.join()
    if _errors:
        raise RuntimeError("nvcc failed for " + ", ".join(_errors) + ":\n"
                           + "\n".join(_errors.values()))


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (a key of ``SIGNATURES``), starting the
    build of every source first if this source hash has no build yet and
    waiting for this source's; raises if its compile failed."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        _start_locked()
    _ready[name].wait()
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        if name in _errors:
            raise RuntimeError(f"nvcc failed for {name}:\n{_errors[name]}")
        cdll = ctypes.CDLL(str(Path(build_info["dir"]) / f"lib{name}.so"))
        for fn, argtypes in SIGNATURES[name].items():
            f = getattr(cdll, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _libs[name] = cdll
        return cdll


def check(err: int, what: str) -> None:
    """Raises if a launcher returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what} launch failed with CUDA error {err}")
