"""The LM seed code's models (counterpart of ``repro.models``): layers,
attention, MoE, the Mamba-2 SSD block, backbone blocks and the LM."""
