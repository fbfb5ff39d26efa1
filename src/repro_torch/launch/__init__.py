"""Command-line entry points of the port (the counterpart of
:mod:`repro.launch`)."""
