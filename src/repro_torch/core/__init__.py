"""GPTQ int4 layout, strategy flags and the round-to-nearest quantizer."""
