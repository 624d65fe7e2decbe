"""Native wire tier: the C NDJSON scanners, built with ``cc`` at first use.

Counterpart of ``sitewhere_tpu/native/__init__.py``.  ``swwire.c`` here is
the port's own copy of the reference's scanner with its module renamed
``_swwire_torch`` (so both packages' extensions load into one process and
a ``TokenTable`` names the package it belongs to); its scanner bodies are
the reference's.

Build model: the extension compiles on first use with the host's C
compiler (``$CC``, default ``cc``) and the CPython headers, into
``sitewhere_tpu_torch/_build/`` keyed by the source hash and the Python
ABI, through a temporary file and ``os.replace`` (concurrent builds of
several processes are safe).  The dispatcher's ``start()`` builds it at
boot.  A failed build raises :class:`NativeBuildError` with the
compiler's output: the port has no pure-Python fallback for a missing
tier.  (Payload shapes the scanners do not take still decode in Python:
that is the scanners' strictness contract, not a fallback.)
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import subprocess
import sysconfig
import threading
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = PKG_DIR / "native" / "swwire.c"
BUILD_DIR = PKG_DIR / "_build"
MODULE = "_swwire_torch"
# -lm for llrint (the fill-direct epoch split), -pthread for the
# TokenTable rwlock the GIL-free resolved scan reads under
CFLAGS = ("-O2", "-shared", "-fPIC", "-pthread")

_swwire = None
_load_lock = threading.Lock()
# Seconds the build of this process took (0.0 when the library was
# already built), and the path it loaded.
build_seconds = 0.0
library_path: Path | None = None
# Decodes that took the pure-Python lane because the native tier was not
# loaded yet, under the reference's ``native.build_fallbacks`` name.  The
# port's load blocks until the build ends (or raises), so no decode ever
# takes that lane and this stays 0; the dispatcher publishes it as a gauge.
build_fallbacks = 0


class NativeBuildError(RuntimeError):
    """The C scanner did not build or load; carries the compiler's output."""


def build_path() -> Path:
    """Where this source and Python ABI build to."""
    digest = hashlib.blake2b(SOURCE.read_bytes() + " ".join(CFLAGS).encode(),
                             digest_size=8).hexdigest()
    abi = sysconfig.get_config_var("SOABI") or "abi"
    return BUILD_DIR / f"{MODULE}-{digest}-{abi}.so"


def _compile(out: Path) -> None:
    cc = os.environ.get("CC", "cc")
    include = sysconfig.get_paths()["include"]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [cc, *CFLAGS, f"-I{include}", str(SOURCE), "-o", str(tmp), "-lm"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise NativeBuildError(f"{' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(
            f"{' '.join(cmd)} failed ({proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)


def load_swwire():
    """The ``_swwire_torch`` module, built on first use; raises
    :class:`NativeBuildError` if it cannot be built or loaded.  A caller
    that arrives while another thread builds waits for that build."""
    global _swwire, build_seconds, library_path
    if _swwire is not None:
        return _swwire
    with _load_lock:
        if _swwire is not None:
            return _swwire
        path = build_path()
        t0 = time.perf_counter()
        if not path.exists():
            _compile(path)
            build_seconds = time.perf_counter() - t0
        spec = importlib.util.spec_from_file_location(MODULE, path)
        mod = importlib.util.module_from_spec(spec)
        try:
            spec.loader.exec_module(mod)  # type: ignore[union-attr]
        except ImportError as e:
            raise NativeBuildError(f"cannot load {path}: {e}") from e
        library_path = path
        _swwire = mod
    return _swwire
