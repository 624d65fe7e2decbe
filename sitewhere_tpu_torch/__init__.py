"""PyTorch/CUDA port of ``sitewhere_tpu`` for one NVIDIA H100.

The JAX package ``sitewhere_tpu`` stays the reference; this package
mirrors its module names (``schema``, ``ops.geo``, ``pipeline.step``,
``pipeline.packed``, ``state.manager`` ...) so each counterpart is easy to
find.  It imports ``torch``, numpy and the standard library only.

Importing the package does nothing else: submodules are imported by the
caller, the one hand-written kernel (``csrc/pip_kernel.cu``) is built at
its first launch and the native wire scanners (``native/swwire.c``) at
their first use, never at import.  Entry points run on ``cuda:0``
unless the caller passes ``device="cpu"`` (see :mod:`.device`).
"""
