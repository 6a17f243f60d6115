"""Observability layer of the port: the metrics registry and span trees."""
