"""Training and serving steps of the port (the counterpart of
:mod:`repro.train`)."""
