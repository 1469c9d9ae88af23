# Lazy exports: SqlGateway (AQP serving) must not drag the LM model stack
# in, and ServeEngine (LLM serving) must not drag the query engine in —
# each resolves on first attribute access (PEP 562).
_EXPORTS = {
    "ServeEngine": ("repro_torch.serve.engine", "ServeEngine"),
    "SqlGateway": ("repro_torch.serve.sql_gateway", "SqlGateway"),
    "GatewayStats": ("repro_torch.serve.sql_gateway", "GatewayStats"),
    "render_dashboard": ("repro_torch.serve.dashboard", "render_dashboard"),
    "write_dashboard": ("repro_torch.serve.dashboard", "write_dashboard"),
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    try:
        module_name, attr = _EXPORTS[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(module_name), attr)
