"""Serving steps: prefill (cache build) and single-token decode.

The counterpart of :mod:`repro.train.serve`. PyTorch runs eagerly, so
each step is a plain closure over the configuration.
"""
from __future__ import annotations

from ..configs.base import ArchConfig
from ..models import model as M


def make_prefill_step(cfg: ArchConfig, mesh=None):

    def prefill_step(params, batch):
        return M.prefill(cfg, params, batch, mesh=mesh)

    return prefill_step


def make_decode_step(cfg: ArchConfig, mesh=None):

    def decode_step(params, caches, tokens, pos):
        return M.decode_step(cfg, params, caches, tokens, pos, mesh=mesh)

    return decode_step
