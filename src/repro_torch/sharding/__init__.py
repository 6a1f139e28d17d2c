"""Sharding of the detection batch (counterpart of ``repro.sharding``)."""
