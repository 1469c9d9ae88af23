"""The distributions of :mod:`pilotbench.tables`, one module a distribution,
named as a column's ``"dist"``.  Each holds ``make(spec, ctx)``: the
column's values, shape ``(ctx.rows,)``, drawn from ``ctx.g`` on
``ctx.device`` in a few large calls; ``ctx.cols`` holds the table's columns
drawn before it and ``ctx.config`` the configuration."""
