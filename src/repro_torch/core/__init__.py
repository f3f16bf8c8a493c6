"""Numerics of the PIM behavioral model: quantization, LUT softmax, PIM
linears and attention."""
