"""The drivers of the traffic kinds, one file each, found by the name that a
traffic file gives under ``kind`` (``run.kind``).  A driver exposes
``load``, ``work``, ``check`` and ``readings``; ``frames.py`` and ``fit.py``
say what each takes and returns."""
