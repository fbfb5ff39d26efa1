"""Sharding rules of the port (the counterpart of :mod:`repro.parallel`)."""
