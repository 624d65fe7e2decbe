#!/usr/bin/env bash
# ASan/UBSan build of the port's C wire scanners + the port's native
# lane tests (fill-direct included) run under the instrumented build.
#
#   tools/torch_native_sanitize.sh           # build + run tests/test_torch_native.py
#   tools/torch_native_sanitize.sh --build   # build only, print the .so path
#
# The production build (sitewhere_tpu_torch/native/__init__.py) compiles
# swwire.c with -O2 on first use; a memory bug in the scanners, which
# parse HOSTILE wire bytes straight into the batcher's packed buffers,
# would corrupt the columns silently.  This rebuilds the port's copy with
# AddressSanitizer + UndefinedBehaviorSanitizer (no recover: any finding
# aborts the run) and runs the port's native lane tests against it through
# SW_NATIVE_LIB, with the sanitizer runtime LD_PRELOADed into the
# (uninstrumented) CPython host.  A missing SW_NATIVE_LIB raises in the
# port (no silent Python fallback), and the preflight below checks that
# the instrumented library is the one loaded.
#
# Run by the slow-marked case of tests/test_torch_tooling.py and runnable
# standalone from any checkout (no card needed).
set -euo pipefail

REPO="$(cd "$(dirname "$0")/.." && pwd)"
SRC="$REPO/sitewhere_tpu_torch/native/swwire.c"
OUT_DIR="${TMPDIR:-/tmp}/sw_torch_native_sanitize"
OUT="$OUT_DIR/_swwire_torch_sanitized.so"
CC="${CC:-cc}"

command -v "$CC" >/dev/null || { echo "torch_native_sanitize: no C compiler" >&2; exit 3; }

INCLUDE="$(python -c 'import sysconfig; print(sysconfig.get_paths()["include"])')"
LIBASAN="$("$CC" -print-file-name=libasan.so)"
if [ ! -e "$LIBASAN" ]; then
    echo "torch_native_sanitize: libasan runtime not found ($LIBASAN)" >&2
    exit 3
fi

mkdir -p "$OUT_DIR"
echo "torch_native_sanitize: building $OUT"
"$CC" -O1 -g -fno-omit-frame-pointer \
    -fsanitize=address,undefined -fno-sanitize-recover=all \
    -shared -fPIC -pthread -I"$INCLUDE" "$SRC" -o "$OUT" -lm

if [ "${1:-}" = "--build" ]; then
    echo "$OUT"
    exit 0
fi

# detect_leaks=0: CPython itself "leaks" interned objects at exit;
# verify_asan_link_order=0: the host python is uninstrumented and the
# runtime arrives via LD_PRELOAD, the inversion that check would reject.
cd "$REPO"
echo "torch_native_sanitize: preflighting instrumented load"
env LD_PRELOAD="$LIBASAN" \
    ASAN_OPTIONS="detect_leaks=0,verify_asan_link_order=0" \
    SW_NATIVE_LIB="$OUT" SW_SANITIZED_SO="$OUT" \
    python -c 'import os, sys
from sitewhere_tpu_torch import native
native.load_swwire()
want = os.environ["SW_SANITIZED_SO"]
if str(native.library_path) != want:
    print("torch_native_sanitize: instrumented .so did not load "
          "(got %r, wanted %r)" % (native.library_path, want),
          file=sys.stderr)
    sys.exit(1)'

# The parity cases hold each port lane against the reference's, whose
# loader reads SW_NATIVE_LIB too: tests/torch_sanitize_plugin.py loads
# the reference's own library with the variable unset before any case
# runs, so only the port loads the instrumented build.  The two
# build-mechanics cases drive the hash-keyed build, which SW_NATIVE_LIB
# replaces by design.
echo "torch_native_sanitize: running tests/test_torch_native.py under ASan/UBSan"
env LD_PRELOAD="$LIBASAN" \
    ASAN_OPTIONS="detect_leaks=0,abort_on_error=1,verify_asan_link_order=0" \
    UBSAN_OPTIONS="print_stacktrace=1,halt_on_error=1" \
    SW_NATIVE_LIB="$OUT" \
    JAX_PLATFORMS=cpu \
    PYTHONPATH="$REPO/tests${PYTHONPATH:+:$PYTHONPATH}" \
    python -m pytest -p torch_sanitize_plugin tests/test_torch_native.py \
        -q -p no:cacheprovider \
        -k "not failed_scanner_build and not concurrent_builds" "$@"
echo "torch_native_sanitize: OK (ASan/UBSan clean)"
