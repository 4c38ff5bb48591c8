"""The MMSS heads: grounding and transformer."""
