"""Atomic, integrity-checked checkpoints: the counterpart of
:mod:`repro.checkpoint`."""
