"""Data pipeline of the port (the counterpart of :mod:`repro.data`)."""
