"""Serving layer (counterpart of ``repro.serving``): so far only the
batch shaping the offline launcher needs; the micro-batcher, the online
server, its caches and the fleet are ROADMAP queue 1 item 13."""
