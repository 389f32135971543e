"""Build the CUDA kernels of ``csrc/`` at first use and load them.

Each ``csrc/*.cu`` compiles with ``nvcc`` for Hopper (``sm_90a``) into its
own shared library with a plain C interface, loaded with ``ctypes``. All
sources compile in parallel, one ``nvcc`` each. The output goes to
``hotstuff_tpu_torch/_build/<key>/``, where the key hashes the sources, the
flags and the card's compute capability, so a library built for other
sources or another card is never loaded. (The JAX package's counterpart is
its compile cache, ``hotstuff_tpu/utils/jaxcache.py``.) Host C++, the native
Ed25519 engine, builds here too, with ``g++`` (``build_native``).
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

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# Per source: (seconds, nvcc's output, which holds ptxas' register counts).
# A library found already built reads its log from beside it, with 0 s.
build_log: dict[str, tuple[float, str]] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise KernelBuildError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _build_key(capability: tuple[int, int]) -> str:
    h = hashlib.sha256()
    for src in sorted(CSRC.iterdir()):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(repr(capability).encode())
    return h.hexdigest()[:16]


def _declare(lib: ctypes.CDLL) -> None:
    vp, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    sigs = {
        "decompress_launch": [vp, vp, vp, vp, i, vp],
        "sqrt_pow_launch": [vp, vp, vp, i, i, vp],
        "msm_partials_signed_launch": [vp, vp, vp, i, i, i, i, vp],
        "msm_partials_unsigned_launch": [vp, vp, vp, i, i, i, i, vp],
        "msm_combine_launch": [vp, vp, vp, vp, i, i, vp],
        "verdict_launch": [vp, i, vp, vp, vp, vp],
        "verdict_tree_launch": [vp, i, vp, vp, i, vp, vp, vp],
        "sha512_launch": [vp, i64, vp, vp, i, vp, vp],
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int


def load_all() -> dict[str, ctypes.CDLL]:
    """Build (if needed) and load every ``csrc/*.cu``; returns the loaded
    libraries by source stem. Thread-safe; builds once per process."""
    with _lock:
        if _libs:
            return _libs
        import torch

        if not torch.cuda.is_available():
            raise KernelBuildError("no CUDA device: the kernels run only on the card")
        cap = torch.cuda.get_device_capability()
        if cap[0] != 9:
            raise KernelBuildError(f"kernels target sm_90a; this card is sm_{cap[0]}{cap[1]}")
        out_dir = BUILD_ROOT / _build_key(cap)
        out_dir.mkdir(parents=True, exist_ok=True)
        sources = sorted(CSRC.glob("*.cu"))
        jobs = []
        for src in sources:
            target = out_dir / f"{src.stem}.so"
            if target.exists():
                log = out_dir / f"{src.stem}.log"
                build_log[src.name] = (0.0, log.read_text() if log.exists() else "")
                continue
            tmp = out_dir / f"{src.stem}.{os.getpid()}.tmp.so"
            cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )
            jobs.append((src, tmp, target, proc, time.perf_counter()))
        failures = []
        for src, tmp, target, proc, t0 in jobs:
            out, _ = proc.communicate()
            build_log[src.name] = (time.perf_counter() - t0, out)
            if proc.returncode != 0:
                failures.append(f"{src.name}:\n{out}")
            else:
                (out_dir / f"{src.stem}.log").write_text(out)
                os.replace(tmp, target)
        if failures:
            raise KernelBuildError("nvcc failed:\n" + "\n".join(failures))
        for src in sources:
            lib = ctypes.CDLL(str(out_dir / f"{src.stem}.so"))
            _declare(lib)
            _libs[src.stem] = lib
        return _libs


def kernel(source_stem: str, fn_name: str):
    """The C entry point ``fn_name`` of ``csrc/<source_stem>.cu``."""
    return getattr(load_all()[source_stem], fn_name)


# Host C++ (the native engines) builds with g++ beside the CUDA libraries,
# keyed by its source and these flags.
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
_native_lock = threading.Lock()


def native_path(source: Path) -> Path:
    """Where ``build_native`` puts the library of ``source``:
    ``_build/native-<key>/lib<stem>.so``."""
    h = hashlib.sha256(source.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_ROOT / f"native-{h.hexdigest()[:16]}" / f"lib{source.stem}.so"


def build_native(source: Path) -> Path:
    """Build the host C++ ``source`` with g++ unless its library is there,
    and return the library's path (``native_path``). Processes may build at
    once (tier-1 runs several workers): each compiles to a name of its own
    and renames it into place, so a reader never sees a half-written
    library. Raises ``KernelBuildError`` when g++ is missing or refuses the
    source."""
    target = native_path(source)
    out_dir = target.parent
    with _native_lock:
        if target.exists():
            return target
        gxx = shutil.which("g++")
        if gxx is None:
            raise KernelBuildError("g++ not found: the native engine cannot be built")
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"lib{source.stem}.{os.getpid()}.tmp.so"
        proc = subprocess.run([gxx, *GXX_FLAGS, str(source), "-o", str(tmp)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise KernelBuildError(f"g++ failed on {source.name}:\n{proc.stderr}")
        os.replace(tmp, target)
        return target
