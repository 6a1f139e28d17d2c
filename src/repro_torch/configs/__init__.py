"""Architecture and shape configs of the LM seed code (counterpart of
``repro.configs``)."""
