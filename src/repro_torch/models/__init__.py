"""Model layers, the attention block and model assembly."""
