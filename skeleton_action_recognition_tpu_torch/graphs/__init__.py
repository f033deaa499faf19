"""Skeleton graph construction (numpy)."""
