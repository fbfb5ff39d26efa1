"""AdamW (float32 or 8-bit block-quantized moments) and learning-rate
schedules: the counterpart of :mod:`repro.optim`."""
