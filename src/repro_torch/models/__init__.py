"""The LM family: shared layers and the decoder-only transformer."""
