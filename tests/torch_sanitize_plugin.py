"""pytest plugin for ``tools/torch_native_sanitize.sh``.

The parity cases of ``tests/test_torch_native.py`` hold each port lane
against the reference's, whose loader reads ``SW_NATIVE_LIB`` too.  At
configure time this builds and loads the reference's own library with the
variable unset, then puts it back, so only the port loads the
instrumented build the script names there.
"""

import os


def pytest_configure(config):
    lib = os.environ.pop("SW_NATIVE_LIB", None)
    try:
        from sitewhere_tpu import native as reference_native

        reference_native.load_swwire()
    finally:
        if lib is not None:
            os.environ["SW_NATIVE_LIB"] = lib
