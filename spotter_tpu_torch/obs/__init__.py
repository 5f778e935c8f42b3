"""Observability of the port: the device-efficiency ledger (`perf`)."""
