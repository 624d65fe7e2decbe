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
:func:`make_instance` builds a wired ``Instance``, importing it at the
call.
"""


def make_instance(config=None, template=None, device=None):
    """Build a fully wired :class:`sitewhere_tpu_torch.instance.Instance`
    (imported here, at the call, so importing the package stays light)."""
    from sitewhere_tpu_torch.instance import Instance

    return Instance(config, template, device=device)

