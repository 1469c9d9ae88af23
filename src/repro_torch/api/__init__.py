"""The user-facing front door: SQL extended with ``ERROR e% CONFIDENCE p%``,
a typed fluent builder, and a Session answering either synchronously
(``sql``, ``table(...).run()``) or through its scheduler (``submit`` /
``drain``), optionally as a stream of frames (``stream=True``)."""

from repro_torch.api.builder import QueryBuilder, avg_, count_, sum_
from repro_torch.api.scheduler import DrainStats, QueryScheduler
from repro_torch.api.session import (QueryFailedError, QueryHandle, QueryStatus,
                                     Session, SessionConfig)
from repro_torch.api.sql import (HavingClause, LimitClause, ParsedQuery,
                                 SqlSyntaxError, UnsupportedSqlError, parse_sql,
                                 render_sql, resolve_string_literals)
from repro_torch.runtime import BackpressureError, ResultCacheInfo
from repro_torch.stream import (ErrorFrame, ExactFrame, FinalFrame, Frame,
                                PilotFrame)

__all__ = [
    "Session",
    "QueryBuilder",
    "sum_",
    "count_",
    "avg_",
    "SessionConfig",
    "QueryHandle",
    "QueryStatus",
    "QueryFailedError",
    "QueryScheduler",
    "DrainStats",
    "parse_sql",
    "render_sql",
    "resolve_string_literals",
    "HavingClause",
    "LimitClause",
    "ParsedQuery",
    "SqlSyntaxError",
    "UnsupportedSqlError",
    "BackpressureError",
    "ResultCacheInfo",
    "Frame",
    "PilotFrame",
    "FinalFrame",
    "ExactFrame",
    "ErrorFrame",
]
