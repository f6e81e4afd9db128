"""On-demand native build with compiler-flag probing.

Mirrors the spirit of the reference's ``setup.py`` ``build_ext_subclass``
(``/root/reference/setup.py:33-258``): probe optimization/OpenMP flags,
fall back gracefully (a no-OpenMP build still works), and honor the same
env overrides (``DONT_SET_MARCH``, ``CFLAGS``).
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile

_SRC = os.path.join(os.path.dirname(__file__), "csr_ops.cpp")


def _probe_flag(cxx: str, flag: str) -> bool:
    """Can the compiler build a trivial TU with this flag?"""
    with tempfile.TemporaryDirectory() as td:
        src = os.path.join(td, "t.cpp")
        with open(src, "w") as f:
            f.write("int main(){return 0;}\n")
        r = subprocess.run(
            [cxx, flag, "-o", os.path.join(td, "t.out"), src],
            capture_output=True,
        )
        return r.returncode == 0


def _cache_dir() -> str:
    d = os.environ.get("HPFREC_NATIVE_CACHE",
                       os.path.join(os.path.expanduser("~"), ".cache", "hpfrec_jax"))
    os.makedirs(d, exist_ok=True)
    return d


def build_native(verbose: bool = False) -> str:
    """Compile csr_ops.cpp to a shared library, cached by a key covering
    the source bytes AND the toolchain configuration (CXX, resolved probe
    flags, CFLAGS) — changing compiler or flags must not reuse a stale
    binary.  Returns the .so path; raises on failure."""
    cxx = os.environ.get("CXX", "g++")

    flags = ["-O3", "-shared", "-fPIC", "-std=c++17"]
    if "DONT_SET_MARCH" not in os.environ and _probe_flag(cxx, "-march=native"):
        flags.append("-march=native")
    for f in ("-fno-math-errno", "-fno-trapping-math"):
        if _probe_flag(cxx, f):
            flags.append(f)
    omp = None
    for cand in ("-fopenmp", "-qopenmp", "-xopenmp"):
        if _probe_flag(cxx, cand):
            omp = cand
            break
    if omp:
        flags.append(omp)
    extra = os.environ.get("CFLAGS", "").split()

    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update("\0".join([cxx, *flags, *extra]).encode())
    tag = h.hexdigest()[:16]
    out = os.path.join(_cache_dir(), f"csr_ops_{tag}.so")
    if os.path.exists(out):
        return out

    cmd = [cxx, *flags, *extra, "-o", out + ".tmp", _SRC]
    if verbose:
        print("building native:", " ".join(cmd))
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"native build failed: {r.stderr[-2000:]}")
    os.replace(out + ".tmp", out)
    return out
