"""Drivers: what runs the program and sends it a session's queries, one
module a layout, ``<name>.py`` with a class ``Driver``, found by the name a
mix gives under ``driver`` (``engine`` where it gives none).

``Driver(setting)``
    ``perfbench.harness.Setting``: ``device``, ``config``, ``cache`` (the
    column cache's directory, or None), ``mix`` and ``sessions``; before
    ``setup`` the harness adds ``store``, ``traffic`` and ``columns``.  May
    start processes; returns without waiting for them.
``setup() -> dict``
    Everything before the window: processes, engines, uploads, and the
    first and second call of every text; the device's peak memory is reset
    at its end.  Returns the seconds of its phases, by name.
``query(session, text, parts) -> reply``
    One query of one session, timed by the harness from the call to the
    return.  ``parts`` is None, or (in a traced run) a list to which the
    driver appends ``(name, perf_counter())`` where a later part of the
    query begins; its first part is named ``PART``.
``answer(reply) -> (rows, numbers, times)``
    After the timing: the answer's rows as ``reference/common.py::judge``
    compares them, the numbers the program reported with it (or None), and
    ``(start, end)`` on the host's ``perf_counter`` where the driver's
    client process timed the query itself (or None: the harness's timing
    from the call to the return stands).
``start_profile() -> sync_ns`` / ``stop_profile() -> prof``
    A CUDA-only profile of the device around the traced queries, opening
    with ``harness.PROFILE_LEAD`` spin kernels; ``sync_ns`` is the host's
    ``perf_counter`` when their synchronize returned, ``prof.events()`` the
    profiler's events (``harness.Trace`` reads them).
``device() -> dict``
    ``kind`` (the card's name) and ``memory_peak_bytes`` since the reset.
``notes() -> dict``
    What a traced run logs of the card after its readers.
``close() -> list``
    Frees the program's state and stops every process it started; returns
    the forbidden modules (``harness.FORBIDDEN``) any of them had loaded,
    and raises ``harness.ForbiddenModules`` where a process stopped
    without naming them.  Safe to call twice.
``program_trace(instances) -> dict`` (optional)
    Where the program runs in another process: the program-span metrics
    (``metrics/_program_trace.py``) of the traced instances, replayed on
    the program's own engine there, or None.
``engine``
    The program's ``Engine`` where it runs in the harness's own process
    (the program-span readers replay on it), else None.
"""
