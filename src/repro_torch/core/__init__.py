"""Packing, the scheduling model and the bit-exactness harness."""
