"""Serving steps of the port (the counterpart of :mod:`repro.train`;
training waits for a later slice)."""
