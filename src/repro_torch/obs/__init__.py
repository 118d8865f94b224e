"""Observability.  Nothing is ported yet: ``obs/metrics`` and ``obs/trace``
come with the scheduler slice, ``obs/profile`` and ``obs/export`` after it."""
