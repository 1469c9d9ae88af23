"""The user-facing front door: SQL extended with ``ERROR e% CONFIDENCE p%``,
a Session answering it synchronously (``sql``) or through its scheduler
(``submit`` / ``drain``)."""

from repro_torch.api.scheduler import DrainStats, QueryScheduler
from repro_torch.api.session import (QueryFailedError, QueryHandle, QueryStatus,
                                     Session, SessionConfig)
from repro_torch.api.sql import (HavingClause, LimitClause, ParsedQuery,
                                 SqlSyntaxError, UnsupportedSqlError, parse_sql,
                                 render_sql, resolve_string_literals)

__all__ = [
    "Session",
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
]
