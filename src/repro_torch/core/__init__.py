"""Offline GF(2) planning: :mod:`.f2`, :mod:`.bmmc`, :mod:`.tiling`."""
