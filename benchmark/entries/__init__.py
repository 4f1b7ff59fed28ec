"""Entries: each binds one kind of traffic to the program's entry points.
A traffic file names its module (``"entry"``); ``run(cell, reference,
t0)`` returns a ``harness.Outcome``."""
