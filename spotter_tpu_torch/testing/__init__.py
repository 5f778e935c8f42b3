"""Test support of the port: fault injection for the serving path (faults.py)."""
