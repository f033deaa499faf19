"""Host-to-device input staging (single device; data parallelism across
cards is not ported yet)."""
