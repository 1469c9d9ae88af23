"""The user-facing front door: SQL extended with ``ERROR e% CONFIDENCE p%``
and a synchronous Session (this slice of the port)."""

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
    "parse_sql",
    "render_sql",
    "resolve_string_literals",
    "HavingClause",
    "LimitClause",
    "ParsedQuery",
    "SqlSyntaxError",
    "UnsupportedSqlError",
]
