"""Hierarchical component lifecycle — the L1 runtime kept from the reference.

The reference makes every runtime object a lifecycle component with status,
nested children and ordered composite steps
(``sitewhere-core-lifecycle/.../LifecycleComponent.java``,
``CompositeLifecycleStep.java``; states in
``spi/server/lifecycle/ILifecycleComponent.java:24-282``).  That shape is
worth keeping — frontends, journals, stores, dispatchers all need ordered
init/start/stop with error containment — but slimmed to a Python protocol:

- ``initialize()`` / ``start()`` / ``stop()`` / ``terminate()`` walk the
  children in order (reverse order for stop), transitioning state;
- errors set ``LifecycleState.ERROR`` and re-raise (the reference records
  the error on the component the same way);
- ``pause()`` maps to stop-without-terminate, as in the reference.
"""

from __future__ import annotations

import enum
import logging
import threading
from typing import List, Optional

logger = logging.getLogger("sitewhere_tpu_torch.lifecycle")


class LifecycleState(enum.Enum):
    UNINITIALIZED = "uninitialized"
    INITIALIZING = "initializing"
    STOPPED = "stopped"
    STARTING = "starting"
    STARTED = "started"
    PAUSING = "pausing"
    PAUSED = "paused"
    STOPPING = "stopping"
    TERMINATING = "terminating"
    TERMINATED = "terminated"
    ERROR = "error"


class LifecycleError(Exception):
    pass


class LifecycleComponent:
    """A runtime object with ordered, nested lifecycle."""

    def __init__(self, name: Optional[str] = None):
        self.name = name or type(self).__name__
        self.state = LifecycleState.UNINITIALIZED
        self.error: Optional[BaseException] = None
        self._children: List["LifecycleComponent"] = []
        self._state_lock = threading.RLock()

    # -- composition --------------------------------------------------------

    def add_child(self, child: "LifecycleComponent") -> "LifecycleComponent":
        self._children.append(child)
        return child

    @property
    def children(self) -> List["LifecycleComponent"]:
        return list(self._children)

    # -- transitions (override the verb, call super() last/first) -----------

    def initialize(self) -> None:
        with self._state_lock:
            self._transition(LifecycleState.INITIALIZING)
            try:
                for child in self._children:
                    if child.state == LifecycleState.UNINITIALIZED:
                        child.initialize()
            except BaseException as e:
                self._fail(e)
                raise
            self.state = LifecycleState.STOPPED

    def start(self) -> None:
        with self._state_lock:
            if self.state == LifecycleState.UNINITIALIZED:
                self.initialize()
            self._transition(LifecycleState.STARTING)
            try:
                for child in self._children:
                    if child.state != LifecycleState.STARTED:
                        child.start()
            except BaseException as e:
                self._fail(e)
                raise
            self.state = LifecycleState.STARTED
            logger.debug("started %s", self.name)

    def pause(self) -> None:
        with self._state_lock:
            self._transition(LifecycleState.PAUSING)
            self.state = LifecycleState.PAUSED

    def stop(self) -> None:
        with self._state_lock:
            if self.state in (LifecycleState.STOPPED, LifecycleState.TERMINATED,
                              LifecycleState.UNINITIALIZED):
                return
            self._transition(LifecycleState.STOPPING)
            first_error: Optional[BaseException] = None
            for child in reversed(self._children):
                if child.state == LifecycleState.STARTED:
                    try:
                        child.stop()
                    except BaseException as e:  # keep stopping the rest
                        first_error = first_error or e
                        logger.exception("error stopping %s", child.name)
            self.state = LifecycleState.STOPPED
            if first_error is not None:
                self._fail(first_error)
                raise LifecycleError(f"stop of {self.name}") from first_error
            logger.debug("stopped %s", self.name)

    def terminate(self) -> None:
        with self._state_lock:
            if self.state == LifecycleState.STARTED:
                self.stop()
            self._transition(LifecycleState.TERMINATING)
            for child in reversed(self._children):
                child.terminate()
            self.state = LifecycleState.TERMINATED

    # -- helpers ------------------------------------------------------------

    def _transition(self, state: LifecycleState) -> None:
        self.state = state

    def _fail(self, error: BaseException) -> None:
        self.error = error
        self.state = LifecycleState.ERROR

    def walk(self):
        """Depth-first iterator over the component tree (topology views)."""
        yield self
        for child in self._children:
            yield from child.walk()

    def status_tree(self) -> dict:
        """Serializable topology snapshot — the analog of the reference's
        microservice-state heartbeats (``TopologyStateAggregator.java``)."""
        return {
            "name": self.name,
            "state": self.state.value,
            "error": repr(self.error) if self.error else None,
            "children": [c.status_tree() for c in self._children],
        }
