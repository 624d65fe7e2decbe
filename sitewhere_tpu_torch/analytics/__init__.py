"""Batch + streaming analytics over event history, on one card.

Counterpart of ``sitewhere_tpu/analytics``: the same exports, minus the
sharded half (``detect_anomalies_window_sharded``).
"""

from sitewhere_tpu_torch.analytics.runner import (  # noqa: F401
    AnalyticsJob,
    Anomaly,
    EventTap,
    QueryRunner,
    WindowGrid,
    build_window_grid,
    detect_anomalies,
)
from sitewhere_tpu_torch.analytics.query import (  # noqa: F401
    PatternQuery,
    QueryMatch,
    SessionQuery,
    WindowQuery,
    compile_query,
    parse_query,
)
from sitewhere_tpu_torch.analytics.windows import (  # noqa: F401
    WindowAggregates,
    aggregate_windows,
    sessionize,
    sliding_aggregates,
)
