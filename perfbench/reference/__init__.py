"""Query templates and their plain NumPy references, one module a
template: ``<suite>_q<k>.py``.

A template module holds the statement's text with its substitution
parameters (``SQL``, ``draw(rng)``), the columns it reads (``COLUMNS``), the
kind of each output column (``OUTPUT``: ``exact`` or ``double``), the output
columns that order its rows (``ORDER_KEY``) and its ``LIMIT``, and the
reference: ``prepare(tables)`` once over the benchmark's host columns, then
``answer(ctx, params, lower=False)`` for one instance.  ``lower=True``
computes the same answer one precision down (decimals as float64, doubles
as float32): that is the control that the comparison has to reject.

Nothing here imports the program.
"""
