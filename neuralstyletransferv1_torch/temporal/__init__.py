"""Temporal-coherence chain: flow EMA, LAB EMA, motion-adaptive blend."""
