"""The traffic modes of :mod:`pilotbench.traffic`, one module a mode, named
as a mix's ``"mode"``.  Each holds:

* ``warm(traffic)`` -- the batches set-up asks, so that the window compiles
  nothing;
* ``batches(traffic)`` -- the window's batches, an endless iterator;
* ``min_batches(traffic)`` -- batches the window asks at the least, past
  its deadline if need be, so that every query the mix can ask is judged;
* ``ask(session, queries)`` -- asks one batch and returns a handle a query,
  each done; the harness times the batch from the call to its return, and a
  mode that times each query itself (an open loop, from when the query was
  due) returns ``(handle, t0, t1)`` instead, on ``time.perf_counter``;
* ``stats(session)`` -- the program's counters of the batch just asked (a
  dict), or None where a batch is a single query.
"""
