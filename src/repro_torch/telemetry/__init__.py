"""Telemetry of the port: so far only the residency accounting models
(``metrics.py``); the event stream, latency histograms and trace scopes
come with a later slice."""
