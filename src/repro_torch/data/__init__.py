"""Token data for the port's trainer (a copy of ``repro.data``)."""
