"""Gemma-3-270M quantization examples (RTN int8 g128, AWQ uint4 g128)."""
