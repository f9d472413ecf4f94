"""The kernels' build (``l2hmc_tpu_torch/ops/_cuda.py``) on the CPU, with a
stand-in for ``nvcc`` that sleeps, writes its output file and can fail: the
sources compile in the background, a library waits for its own source only,
a failed source raises for itself and for the whole build, and a finished
build loads without a compiler. Loading is stood in for too (``ctypes.CDLL``
of the written files), so no card and no toolkit are needed."""

import os
import time

import pytest

from l2hmc_tpu_torch.ops import _cuda

FAKE_NVCC = """#!/bin/sh
out=""; src=""
while [ $# -gt 0 ]; do
  case "$1" in -o) out="$2"; shift;; *.cu) src="$1";; esac
  shift
done
name=$(basename "$src" .cu)
sleep "$(cat "$(dirname "$src")/$name.delay")"
if [ "$name" = "bad" ]; then echo "bad.cu(1): error: no kernel here"; exit 1; fi
echo "ptxas info    : Used 8 registers ($name, niceness $(nice))"
echo built > "$out"
"""


class _FakeLibrary:
    def __init__(self, path):
        self.path = path

    def __getattr__(self, name):
        fn = type("Fn", (), {})()
        self.__dict__[name] = fn
        return fn


@pytest.fixture
def build(tmp_path, monkeypatch):
    """A source directory of ``<name>.cu`` files, each compiled by the
    stand-in in its ``<name>.delay`` seconds, and the build module's state
    fresh; returns a function that lays out the sources."""
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    nvcc = home / "bin" / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(home))
    monkeypatch.setattr(_cuda, "_BUILD", tmp_path / "build")
    monkeypatch.setattr(_cuda.ctypes, "CDLL", _FakeLibrary)

    def fresh_state():
        for name, value in (("_libs", {}), ("_ready", {}), ("_errors", {}), ("_watcher", []),
                            ("build_info", {})):
            monkeypatch.setattr(_cuda, name, value)

    def sources(delays):
        csrc = tmp_path / "csrc"
        csrc.mkdir(exist_ok=True)
        for name, delay in delays.items():
            (csrc / f"{name}.cu").write_text(f"// {name}\n")
            (csrc / f"{name}.delay").write_text(str(delay))
        monkeypatch.setattr(_cuda, "_CSRC", csrc)
        monkeypatch.setattr(_cuda, "SIGNATURES", {n: {f"l2hmc_{n}": [_cuda._I]} for n in delays})
        fresh_state()
        return _cuda._BUILD / _cuda._source_hash()

    sources.fresh_state = fresh_state
    return sources


def test_a_library_waits_for_its_own_source_only(build):
    out = build({"fast": 0, "slow": 2.5})
    t = time.perf_counter()
    _cuda.start_build()
    assert time.perf_counter() - t < 0.5  # returns at once
    fast = _cuda.library("fast")
    assert time.perf_counter() - t < 2.0
    assert fast.path == str(out / "libfast.so")
    assert not (out / "libslow.so").exists()  # still compiling
    _cuda.wait_build()
    assert time.perf_counter() - t >= 2.5
    assert (out / "libslow.so").exists() and (out / "ptxas.log").exists()
    assert set(_cuda.build_info["seconds_by_source"]) == {"fast", "slow"}
    assert _cuda.build_info["seconds_by_source"]["slow"] >= 2.5
    assert _cuda.build_info["seconds"] >= _cuda.build_info["seconds_by_source"]["slow"]
    assert "(fast, " in _cuda.build_info["ptxas"]
    # below the caller's priority (the stand-in reads its niceness after its sleep)
    niceness = min(19, os.nice(0) + _cuda.NICENESS)
    assert f"(slow, niceness {niceness})" in _cuda.build_info["ptxas"]
    assert _cuda.library("slow").path == str(out / "libslow.so")
    assert _cuda.library("fast") is fast
    assert not list(out.glob("*.tmp*"))  # logs and partial outputs gone


def test_a_failed_source_raises_for_itself_and_for_the_build(build):
    out = build({"good": 0, "bad": 0.2})
    assert _cuda.library("good").path == str(out / "libgood.so")
    with pytest.raises(RuntimeError, match=r"nvcc failed for bad:\n.*no kernel here"):
        _cuda.library("bad")
    with pytest.raises(RuntimeError, match="nvcc failed for bad"):
        _cuda.wait_build()
    assert not (out / "libbad.so").exists()


def test_a_finished_build_loads_without_a_compiler(build, monkeypatch):
    out = build({"one": 0, "two": 0})
    _cuda.wait_build()
    build.fresh_state()
    monkeypatch.setenv("CUDA_HOME", str(out / "no-toolkit"))
    monkeypatch.setenv("PATH", "/nonexistent")
    assert _cuda.library("two").path == str(out / "libtwo.so")
    assert _cuda.build_info["seconds"] == 0.0
    assert "(one, " in _cuda.build_info["ptxas"]
