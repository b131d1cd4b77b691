"""Observability shared by the port's serving path: metrics
(``metrics.py``), spans (``tracing.py``) and the flight recorder
(``events.py``)."""
