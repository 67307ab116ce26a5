"""Observability of the port: device-memory readings (``memory``)."""
