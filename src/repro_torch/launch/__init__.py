"""Launchers of the port (``repro.launch`` counterparts)."""
