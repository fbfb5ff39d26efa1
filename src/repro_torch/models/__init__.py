"""The language-model stack of the port (the counterpart of
:mod:`repro.models`): layers, the BMMC permute layer, blockwise attention
with the kv-head shuffle, the dense block stack, the model facade and the
weight conversion from the reference's numpy trees."""
