"""Synthetic images and the LM token stream (counterpart of
``repro.data``)."""
