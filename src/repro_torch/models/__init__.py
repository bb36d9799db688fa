"""Model stacks of the port: the decoder-only LM transformer (dense)."""
