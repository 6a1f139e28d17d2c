"""Checkpointing of the LM seed code (counterpart of ``repro.ckpt``)."""
