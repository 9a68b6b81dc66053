"""The scheduling core (framework-free copies of ``repro.core``)."""
