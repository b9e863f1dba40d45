"""Model decode: layers, attention, the ATTN-family stack."""
