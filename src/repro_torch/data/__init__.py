"""Synthetic image data (counterpart of ``repro.data``)."""
