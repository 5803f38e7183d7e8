"""Compile-and-cache loader for the port's native host C++ (the port of
the reference's ``utils/cbuild.py``; today ``sim/_hostsim.cpp``).

``g++`` compiles a source on first use into a shared library under
``<checkout>/build/aiocluster_torch/host/``, beside the CUDA builds, named
by a sha256 of the SOURCE + COMPILE FLAGS + HOST ISA. The ISA term
matters when ``-march=native`` is among the flags: a shared build
directory must never hand an AVX-512 binary to a host without it, so the
host's cpuinfo flags line takes part in the key. An atomic rename keeps
concurrent builders race-free. A failed build raises with g++'s stderr:
nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "aiocluster_torch" / "host"


class NativeBuildError(RuntimeError):
    """g++ could not build (or the loader could not load) a native
    library; the message carries the compiler's error."""


def host_isa_tag() -> str:
    """A short digest of this host's ISA surface (uname machine + the
    cpuinfo feature flags). Only affects the cache key."""
    bits = os.uname().machine
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    bits += line
                    break
    except OSError:
        pass
    return hashlib.sha256(bits.encode()).hexdigest()[:8]


def build_and_load(
    src: Path,
    flags: tuple[str, ...] = ("-O2",),
    timeout: float = 180.0,
) -> ctypes.CDLL:
    """Compile ``src`` with g++ into a shared library under ``BUILD_DIR``
    (once per source, flags and host ISA) and load it. Raises
    ``NativeBuildError`` with the compiler's stderr when g++ is missing,
    fails or times out."""
    build_dir = BUILD_DIR
    source = src.read_bytes()
    key = hashlib.sha256(
        source + " ".join(flags).encode() + host_isa_tag().encode()
    ).hexdigest()[:16]
    so_path = build_dir / f"{src.stem}-{key}.so"
    if not so_path.exists():
        build_dir.mkdir(parents=True, exist_ok=True)
        with tempfile.NamedTemporaryFile(dir=build_dir, suffix=".so", delete=False) as tmp:
            tmp_path = Path(tmp.name)
        cmd = ["g++", *flags, "-shared", "-fPIC", "-std=c++17", str(src), "-o", str(tmp_path)]
        try:
            subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=timeout)
            tmp_path.replace(so_path)
        except subprocess.CalledProcessError as exc:
            raise NativeBuildError(
                f"g++ failed to build {src.name} ({' '.join(cmd)}):\n{exc.stderr}"
            ) from None
        except (OSError, subprocess.TimeoutExpired) as exc:
            raise NativeBuildError(f"g++ could not build {src.name}: {exc}") from None
        finally:
            tmp_path.unlink(missing_ok=True)
    try:
        return ctypes.CDLL(str(so_path))
    except OSError as exc:
        raise NativeBuildError(f"cannot load {so_path}: {exc}") from None
