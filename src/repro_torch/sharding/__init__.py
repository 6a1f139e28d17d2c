"""The detection batch's data-parallel split and the LM's plan
(counterpart of ``repro.sharding``)."""
