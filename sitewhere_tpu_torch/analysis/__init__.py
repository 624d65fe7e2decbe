"""swlint: project-invariant static analysis for the PyTorch port.

Counterpart of ``sitewhere_tpu/analysis/``.  The port's flagship
guarantees are invariants of the SOURCE, not just of the paths the
dynamic tests happen to execute: host syncs == steps/K on the step path,
no card transfer under the dispatcher's or the state manager's hot
locks, no step writing into a leased carry, no read of a reservation
after its commit.  This package makes them statically checkable:

- ``trace_purity``  (TP): no host sync inside the step set (the
  functions a packed chain, ``shard_map`` or the declared root table
  runs on the card); no uncounted blocking device-to-host copy on the
  dispatch path.  The step set is also the worklist of CUDA-graph
  capture: a graph cannot hold a sync.
- ``locks``         (LK): lock-order inversions, self-deadlocks, and
  blocking / card work under the hot-path locks.
- ``donation``      (DN): no in-place write into a step's carry, no use
  of a leased epoch after its commit, no use of a reservation after its
  commit/abort.
- ``hotpath``       (HP): allocations under ``@hot_path`` markers.
- ``metric_names``  (MN): the registry-driven metric naming contract.

Run it: ``python tools/torch_swlint.py sitewhere_tpu_torch/`` (CLI with
baseline / JSON output) or through ``tests/test_torch_swlint.py``.  The
suite must stay CLEAN: zero unsuppressed findings; new findings are
either fixed or triaged into ``tools/torch_swlint_baseline.json`` with a
one-line justification.

Only the inert ``hot_path`` marker is imported eagerly (the hot
production modules decorate with it); the analysis machinery loads
lazily (PEP 562) so marking a function never drags the AST passes into
a serving process.
"""

from sitewhere_tpu_torch.analysis.markers import hot_path, is_hot_path  # noqa: F401

_LAZY = {
    "Baseline": "sitewhere_tpu_torch.analysis.core",
    "Finding": "sitewhere_tpu_torch.analysis.core",
    "Project": "sitewhere_tpu_torch.analysis.core",
    "run_suite": "sitewhere_tpu_torch.analysis.suite",
    "check_clean": "sitewhere_tpu_torch.analysis.suite",
    "default_passes": "sitewhere_tpu_torch.analysis.suite",
    "PASS_FACTORIES": "sitewhere_tpu_torch.analysis.suite",
    "default_baseline_path": "sitewhere_tpu_torch.analysis.suite",
}

__all__ = ["hot_path", "is_hot_path", *_LAZY]


def __getattr__(name):
    target = _LAZY.get(name)
    if target is None:
        raise AttributeError(name)
    import importlib

    return getattr(importlib.import_module(target), name)
