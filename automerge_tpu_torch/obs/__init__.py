"""Observability layer of the port: the metrics registry, span trees (with
their JSON-lines export), the flight recorder, amscope request-flow
tracing (``scope``), SLO burn rates (``slo``) and live telemetry export
(``export``)."""
