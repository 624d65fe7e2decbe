"""Schedule management — timed (batch) command invocations.

Counterpart of ``sitewhere_tpu/services/schedules.py``, whole.

Reference: ``service-schedule-management`` — Quartz-backed
``QuartzScheduleManager.java`` with ``ISchedule`` (simple
interval/repeat or cron trigger, optional start/end window) and scheduled
jobs (``jobs/CommandInvocationJob.java``,
``jobs/BatchCommandInvocationJob.java``).  Quartz is replaced by a single
ticker thread + a pure next-fire computation (unit-testable without
sleeping): simple triggers fire every ``interval_s`` up to ``repeat_count``
times; cron triggers support the standard 5-field subset
(``m h dom mon dow`` with ``*``, lists, ranges, ``*/n``).
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Callable, Dict, List, Optional

from sitewhere_tpu_torch.runtime.lifecycle import LifecycleComponent
from sitewhere_tpu_torch.services.common import (
    Entity,
    EntityNotFound,
    SearchCriteria,
    SearchResults,
    ValidationError,
    mint_token,
    now_s,
    paged,
    require,
)

logger = logging.getLogger("sitewhere_tpu_torch.schedules")

#: the reference module the records pickle under (``_PICKLE_AS``)
_REF = "sitewhere_tpu.services.schedules"


# -- cron subset -------------------------------------------------------------


def _parse_field(spec: str, lo: int, hi: int) -> frozenset:
    out = set()
    for part in spec.split(","):
        step = 1
        rng = part
        has_step = "/" in part
        if has_step:
            rng, step_s = part.split("/", 1)
            step = int(step_s)
            if step <= 0:
                raise ValidationError(f"bad cron step {step_s}")
        if rng in ("*", ""):
            lo_p, hi_p = lo, hi
        elif "-" in rng:
            a, b = rng.split("-", 1)
            lo_p, hi_p = int(a), int(b)
        else:
            lo_p = int(rng)
            # cron: "a/n" means start at a, step n to the field max.
            hi_p = hi if has_step else lo_p
        if lo_p > hi_p:
            raise ValidationError(f"reversed cron range {part!r}")
        if not (lo <= lo_p <= hi and lo <= hi_p <= hi):
            raise ValidationError(f"cron field {spec} out of range [{lo},{hi}]")
        out.update(range(lo_p, hi_p + 1, step))
    return frozenset(out)


@dataclasses.dataclass(frozen=True)
class CronSpec:
    """Parsed 5-field cron expression."""

    minutes: frozenset
    hours: frozenset
    dom: frozenset
    months: frozenset
    dow: frozenset  # cron numbering: 0=Sunday .. 6=Saturday (7 accepted as Sunday)
    # Vixie-cron day rule: when BOTH day fields are restricted (neither was
    # "*"), a day matches if EITHER matches; otherwise both must match.
    dom_star: bool = True
    dow_star: bool = True

    @classmethod
    def parse(cls, expr: str) -> "CronSpec":
        fields = expr.split()
        require(len(fields) == 5, ValidationError(f"cron needs 5 fields: {expr!r}"))
        return cls(
            minutes=_parse_field(fields[0], 0, 59),
            hours=_parse_field(fields[1], 0, 23),
            dom=_parse_field(fields[2], 1, 31),
            months=_parse_field(fields[3], 1, 12),
            dow=frozenset(d % 7 for d in _parse_field(fields[4], 0, 7)),
            # Vixie sets the star flag when the field BEGINS with '*'
            # ("*/2" counts as star for the day-OR rule).
            dom_star=fields[2].startswith("*"),
            dow_star=fields[4].startswith("*"),
        )

    def _day_matches(self, t: time.struct_time) -> bool:
        dom_ok = t.tm_mday in self.dom
        dow_ok = (t.tm_wday + 1) % 7 in self.dow
        if not self.dom_star and not self.dow_star:
            return dom_ok or dow_ok
        return dom_ok and dow_ok

    def matches(self, t: time.struct_time) -> bool:
        return (
            t.tm_min in self.minutes
            and t.tm_hour in self.hours
            and t.tm_mon in self.months
            and self._day_matches(t)
        )

    def next_fire(self, after_s: int, horizon_days: int = 366) -> Optional[int]:
        """Smallest minute-aligned time > after_s matching the spec.

        Skips whole days/hours whose date/hour fields don't match, so a
        never-matching spec (e.g. Feb 31) costs ~hundreds of localtime
        calls over the horizon, not one per minute.
        """
        t = (after_s // 60 + 1) * 60
        end = after_s + horizon_days * 86400
        while t <= end:
            st = time.localtime(t)
            if not (st.tm_mon in self.months and self._day_matches(st)):
                # jump to the next local midnight (sec offset keeps t
                # minute-aligned; DST shifts are re-checked next loop)
                t += (
                    (24 - st.tm_hour) * 3600 - st.tm_min * 60 - st.tm_sec
                )
                continue
            if st.tm_hour not in self.hours:
                t += 3600 - st.tm_min * 60 - st.tm_sec
                continue
            if st.tm_min in self.minutes:
                return t
            t += 60
        return None


# -- model -------------------------------------------------------------------


@dataclasses.dataclass
class Schedule(Entity):
    """Reference ``ISchedule``: trigger + optional active window."""

    _PICKLE_AS = (_REF, "Schedule")

    name: str = ""
    trigger_type: str = "Simple"  # Simple | Cron
    interval_s: int = 60          # Simple
    repeat_count: int = -1        # Simple; -1 = forever
    cron: str = ""                # Cron
    start_s: Optional[int] = None
    end_s: Optional[int] = None

    def spec(self) -> Optional[CronSpec]:
        return CronSpec.parse(self.cron) if self.trigger_type == "Cron" else None


@dataclasses.dataclass
class ScheduledJob(Entity):
    """Reference ``IScheduledJob``: what to run when the schedule fires."""

    _PICKLE_AS = (_REF, "ScheduledJob")

    schedule: str = ""
    job_type: str = "CommandInvocation"  # or BatchCommandInvocation
    config: Dict[str, object] = dataclasses.field(default_factory=dict)
    fire_count: int = 0
    last_fire_s: Optional[int] = None


JobExecutor = Callable[[ScheduledJob], None]


class ScheduleManager(LifecycleComponent):
    """Schedules + jobs + the ticker that fires them.

    ``executors`` maps job type → callable; the node wires
    ``CommandInvocation`` to the command processor and
    ``BatchCommandInvocation`` to the batch manager (reference job classes).
    """

    def __init__(
        self,
        executors: Optional[Dict[str, JobExecutor]] = None,
        tick_s: float = 1.0,
        name: str = "schedule-manager",
    ):
        super().__init__(name)
        self.executors = dict(executors or {})
        self.tick_s = tick_s
        self.schedules: Dict[str, Schedule] = {}
        self.jobs: Dict[str, ScheduledJob] = {}
        self._lock = threading.RLock()
        # schedule token → (next_fire_s, fires_so_far)
        self._next: Dict[str, int] = {}
        self._fires: Dict[str, int] = {}
        self._ticker: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- CRUD ----------------------------------------------------------------

    def create_schedule(self, token: Optional[str] = None, **fields) -> Schedule:
        with self._lock:
            token = token or mint_token("sched")
            require(token not in self.schedules, ValidationError(f"schedule {token} exists"))
            s = Schedule(token=token, **fields)
            require(
                s.trigger_type in ("Simple", "Cron"),
                ValidationError(f"bad trigger type {s.trigger_type}"),
            )
            if s.trigger_type == "Cron":
                CronSpec.parse(s.cron)  # validate now
            else:
                require(s.interval_s > 0, ValidationError("interval must be positive"))
            self.schedules[token] = s
            self._schedule_next(s, base_s=max(now_s(), s.start_s or 0))
            return s

    def get_schedule(self, token: str) -> Schedule:
        s = self.schedules.get(token)
        require(s is not None, EntityNotFound(f"schedule {token}"))
        return s

    def list_schedules(self, criteria: Optional[SearchCriteria] = None) -> SearchResults[Schedule]:
        with self._lock:
            return paged(sorted(self.schedules.values(), key=lambda s: s.token), criteria)

    def delete_schedule(self, token: str) -> Schedule:
        with self._lock:
            s = self.schedules.pop(token, None)
            require(s is not None, EntityNotFound(f"schedule {token}"))
            self._next.pop(token, None)
            self._fires.pop(token, None)
            for job in [j for j in self.jobs.values() if j.schedule == token]:
                del self.jobs[job.token]
            return s

    def create_job(self, token: Optional[str] = None, **fields) -> ScheduledJob:
        with self._lock:
            token = token or mint_token("job")
            require(token not in self.jobs, ValidationError(f"job {token} exists"))
            job = ScheduledJob(token=token, **fields)
            require(job.schedule in self.schedules, EntityNotFound(f"schedule {job.schedule}"))
            require(
                job.job_type in self.executors or not self.executors,
                ValidationError(f"no executor for job type {job.job_type}"),
            )
            self.jobs[token] = job
            return job

    def get_job(self, token: str) -> ScheduledJob:
        job = self.jobs.get(token)
        require(job is not None, EntityNotFound(f"job {token}"))
        return job

    def list_jobs(
        self, criteria: Optional[SearchCriteria] = None, schedule: Optional[str] = None
    ) -> SearchResults[ScheduledJob]:
        with self._lock:
            items = sorted(self.jobs.values(), key=lambda j: j.token)
        if schedule is not None:
            items = [j for j in items if j.schedule == schedule]
        return paged(items, criteria)

    def delete_job(self, token: str) -> ScheduledJob:
        with self._lock:
            job = self.jobs.pop(token, None)
            require(job is not None, EntityNotFound(f"job {token}"))
            return job

    # -- firing --------------------------------------------------------------

    def _schedule_next(self, s: Schedule, base_s: int) -> None:
        fires = self._fires.get(s.token, 0)
        if s.trigger_type == "Simple":
            if s.repeat_count >= 0 and fires > s.repeat_count:
                self._next.pop(s.token, None)
                return
            nxt = base_s if fires == 0 else base_s + s.interval_s
        else:
            spec = s.spec()
            nxt = spec.next_fire(base_s)
            if nxt is None:
                self._next.pop(s.token, None)
                return
        if s.end_s is not None and nxt > s.end_s:
            self._next.pop(s.token, None)
            return
        self._next[s.token] = nxt

    def due_schedules(self, at_s: Optional[int] = None) -> List[str]:
        at_s = at_s if at_s is not None else now_s()
        with self._lock:
            return [tok for tok, t in self._next.items() if t <= at_s]

    def fire(self, schedule_token: str, at_s: Optional[int] = None) -> int:
        """Run all jobs attached to a schedule; returns jobs fired.

        Public so tests (and the REST trigger endpoint) can fire without
        waiting on wall-clock.
        """
        at_s = at_s if at_s is not None else now_s()
        with self._lock:
            s = self.get_schedule(schedule_token)
            jobs = [j for j in self.jobs.values() if j.schedule == schedule_token]
            self._fires[schedule_token] = self._fires.get(schedule_token, 0) + 1
            self._schedule_next(s, base_s=at_s)
        fired = 0
        for job in jobs:
            executor = self.executors.get(job.job_type)
            if executor is None:
                logger.warning("no executor for job type %s", job.job_type)
                continue
            try:
                executor(job)
                job.fire_count += 1
                job.last_fire_s = at_s
                fired += 1
            except Exception:
                logger.exception("scheduled job %s failed", job.token)
        return fired

    def _tick(self) -> None:
        for token in self.due_schedules():
            try:
                self.fire(token)
            except EntityNotFound:
                # deleted between due_schedules() and fire() — drop its slot
                with self._lock:
                    self._next.pop(token, None)
            except Exception:
                logger.exception("firing schedule %s failed", token)

    def _tick_loop(self) -> None:
        while not self._stop.wait(self.tick_s):
            try:
                self._tick()
            except Exception:
                logger.exception("schedule tick failed")

    def start(self) -> None:
        super().start()
        self._stop.clear()
        self._ticker = threading.Thread(target=self._tick_loop, name=self.name, daemon=True)
        self._ticker.start()

    def stop(self) -> None:
        self._stop.set()
        if self._ticker is not None:
            self._ticker.join(timeout=5)
            self._ticker = None
        super().stop()
